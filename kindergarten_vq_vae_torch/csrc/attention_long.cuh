// Attention of sentences longer than 32 tokens (up to 512 queries and 512
// keys, head_dim <= 128), forward and backward, in bf16 and in f32: the path
// that attention.cuh (bf16) and attention_f32.cuh (f32) take where their
// one-warp-per-(sentence, head) kernels, which hold at most two m16 blocks of
// queries and of keys, do not reach. Every caller of those two goes through
// it: the layer kernels (layer_fwd.cu #1; layer_bwd.cu #3 / #4 inside #2) and
// the standalone attention (sdpa.cu #11, #12, #13). It replaces, at these
// lengths, the same TPU attention as attention.cuh
// (kindergarten_vq_vae_tpu/ops/): layer_pallas.py:244 `_attn_fwd_tile`
// (inside `_layer_fwd_kernel` l.489), l.696 `_attn_bwd_self_kernel`, l.712
// `_attn_bwd_cross_kernel`, sdpa_pallas.py:103 `_sdpa_fwd_kernel`, l.142
// `_sdpa_bwd_kernel` and attention_pallas.py:65 `_mha_kernel`, which take
// any sequence length.
//
// The function and its rounding points are the short path's: f32 scores q
// k^T * scale plus the finite NEG_INF of a masked key or of j > i under the
// causal mask (#13, WHERE_MASK: replaced by it), p = e / z with e = expf(x -
// max) over the real keys (#13: e * (1 / z)), the hash-dropout keep mask of
// dropout_hash.cuh on the same ids (query row b * s_q + i, key j, op id
// op_base + h), p rounded to the compute dtype before p @ v; the backward
// recomputes p, takes dp = (g v^T) * kappa, t = rowsum(dp * p), ds = p (dp -
// t) * scale rounded to the compute dtype before dq and dk, and dv from the
// rounded p * kappa. In f32 the roundings are identities.
//
// Design (a first kernel that is right; it is not yet fast):
// - the tiles are 64 rows of queries or keys, in shared memory as f32 (bf16
//   converted on load: its products are exact in f32), at a row stride of
//   head_dim padded to 64 or 128, plus one (fragment reads free of bank
//   conflicts); rows past the sentence are zero;
// - every product runs on the CUDA cores: 128 threads, thread (ty, tx) owns
//   rows ty + 16 r (r < 4) and columns tx + 8 c of a tile's result, and sums
//   over head_dim (or over the 64 rows of a tile) in order with FMAs;
// - forward: a block takes a (sentence, head, 64-query tile). A first sweep
//   over the key tiles keeps each row's running max and sum of exp (online);
//   a second computes p = e / z with the final max and sum, exactly as the
//   short path does, stages the rounded p in shared memory and adds p V;
// - backward: a block takes a (sentence, head), so it owns every row of the
//   sentence and writes no atomics. For each query tile, a first sweep over
//   the key tiles gives each row's max, sum of exp and t (the sum of e * dp
//   * kappa, rescaled with the sum), kept in shared memory; a second gives
//   ds and adds ds K into dq. Then for each key tile a sweep over the query
//   tiles recomputes p^T and dp^T (key rows, query columns) from the kept
//   statistics and adds (p kappa)^T G into dv and ds^T Q into dk. Each sum
//   runs in a fixed order: two launches give the same bits.
// What bounds it: at 64 tokens x 64 head_dim the forward does 3 and the
// backward 9 products of 64 x 64 x 64 a (sentence, head), ~0.8 and ~2.4 MFLOP
// on ~16 and ~32 KB: at f32 FMA rates (67 TFLOP/s, 20 FLOP a byte) the
// operations bound it (the tensor cores' rates would leave the bytes), and
// these FMAs read both operands from shared memory (12 loads for 32 FMAs).
// mma.sync tiles are the next step.
#pragma once

#include <cmath>
#include <cstdint>

#include "dropout_hash.cuh"
#include "layer_common.cuh"

// Internal linkage in the including file's own anonymous namespace, as
// attention.cuh.
namespace {

using namespace kvq;

constexpr float NEG_INF = -1e9f;        // finite, as sdpa_pallas.py NEG_INF
constexpr int ATL_MAX_S = 512;          // BERT's max_position_embeddings
constexpr int ATL_MAX_HD = 128;
constexpr int ATL_TILE = 64;            // rows of queries or keys a tile
constexpr int ATL_THREADS = 128;        // 16 x 8: rows ty + 16 r, columns tx + 8 c
constexpr int ATL_PLD = ATL_TILE + 1;   // row stride of a 64 x 64 score tile

// The arguments of every attention kernel: T is bf16 (attention.cuh's
// AttArgs) or float (attention_f32.cuh's AttF32Args).
template <typename T>
struct AttnArgs {
  const T* q;
  const T* k;
  const T* v;
  const int* key_mask;  // (batch, s_k) int32 or null (all keys valid)
  const T* g;           // backward: the context gradient, rows of nh * hd
  T* out;               // forward: ctx; backward: dq
  T* dk;
  T* dv;
  int q_ld, kv_ld, out_ld, dkv_ld;
  int batch, nh, hd, s_q, s_k, causal, op_base;
  float scale;
  DropoutParams drop;
};

template <typename T>
struct AtlIO;
template <>
struct AtlIO<bf16> {
  __device__ __forceinline__ static float load(const bf16* p) { return __bfloat162float(*p); }
  __device__ __forceinline__ static void store(bf16* p, float v) { *p = __float2bfloat16(v); }
  __device__ __forceinline__ static float round(float v) { return bf16_round(v); }
};
template <>
struct AtlIO<float> {
  __device__ __forceinline__ static float load(const float* p) { return *p; }
  __device__ __forceinline__ static void store(float* p, float v) { *p = v; }
  __device__ __forceinline__ static float round(float v) { return v; }
};

// Bytes of shared memory of a block: the forward's q, k, v tiles and p tile,
// the backward's q, g, k, v tiles, two score tiles and the rows' max, sum
// and t; last, the sentence's key mask. NC: head_dim padded to 8 NC.
__host__ __device__ constexpr int atl_smem_bytes(int nc, bool bwd) {
  return ((bwd ? 4 : 3) * ATL_TILE * (8 * nc + 1) + (bwd ? 2 : 1) * ATL_TILE * ATL_PLD +
          (bwd ? 3 * ATL_MAX_S : 0)) * 4 + ATL_MAX_S * 4;
}

__device__ __forceinline__ float atl_row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float atl_row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// Rows row0 .. row0 + 63 of src (head_dim columns, row stride src_ld) into a
// tile at row stride ld, as f32; rows at or past `rows` are zero.
template <typename T>
__device__ __forceinline__ void atl_load(float* dst, int ld, const T* src, int src_ld, int row0,
                                         int rows, int hd) {
  for (int e = threadIdx.x; e < ATL_TILE * hd; e += ATL_THREADS) {
    const int r = e / hd, c = e - r * hd, row = row0 + r;
    dst[r * ld + c] = row < rows ? AtlIO<T>::load(src + (size_t)row * src_ld + c) : 0.0f;
  }
}

// acc[r][c] += sum over k < K of A[ty + 16 r][k] * B[tx + 8 c][k]
template <int NC>
__device__ __forceinline__ void atl_abt(float (&acc)[4][NC], const float* A, int lda,
                                        const float* B, int ldb, int K, int ty, int tx) {
  for (int k = 0; k < K; ++k) {
    float x[4], y[NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = A[(ty + 16 * r) * lda + k];
#pragma unroll
    for (int c = 0; c < NC; ++c) y[c] = B[(tx + 8 * c) * ldb + k];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
  }
}

// acc[r][c] += sum over k < 64 of A[ty + 16 r][k] * B[k][tx + 8 c]
template <int NC>
__device__ __forceinline__ void atl_ab(float (&acc)[4][NC], const float* A, int lda,
                                       const float* B, int ldb, int ty, int tx) {
  for (int k = 0; k < ATL_TILE; ++k) {
    float x[4], y[NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = A[(ty + 16 * r) * lda + k];
#pragma unroll
    for (int c = 0; c < NC; ++c) y[c] = B[k * ldb + tx + 8 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
  }
}

// The masked, scaled score of query i and key j (< s_k) from q.k.
template <bool WHERE_MASK, typename T>
__device__ __forceinline__ float atl_score(float acc, int i, int j, const AttnArgs<T>& a,
                                           const int* msk) {
  const bool ok = msk[j] > 0 && !(a.causal && j > i);
  if constexpr (WHERE_MASK) return ok ? acc * a.scale : NEG_INF;
  return acc * a.scale + (ok ? 0.0f : NEG_INF);
}

// zero the tiles; the key mask (1 everywhere without one)
template <typename T>
__device__ __forceinline__ void atl_start(float* smem, int floats, int* msk, const AttnArgs<T>& a,
                                          int b) {
  for (int i = threadIdx.x; i < floats; i += ATL_THREADS) smem[i] = 0.0f;
  for (int j = threadIdx.x; j < a.s_k; j += ATL_THREADS)
    msk[j] = a.key_mask == nullptr ? 1 : a.key_mask[(size_t)b * a.s_k + j];
  __syncthreads();
}

// rows row0 + ty + 16 r (< rows), columns tx + 8 c (< hd) of acc, rounded
// to T, to dst (row stride ld)
template <typename T, int NC>
__device__ __forceinline__ void atl_store(T* dst, int ld, const float (&acc)[4][NC], int row0,
                                          int rows, int hd, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + ty + 16 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 8 * c;
      if (d < hd) AtlIO<T>::store(dst + (size_t)row * ld + d, acc[r][c]);
    }
  }
}

// Forward: block (sentence, head, query tile).
template <typename T, bool WHERE_MASK, int NC>
__global__ void __launch_bounds__(ATL_THREADS) attention_long_kernel(AttnArgs<T> a) {
  extern __shared__ __align__(16) float atl_smem[];
  constexpr int LD = 8 * NC + 1;
  float* qs = atl_smem;
  float* ks = qs + ATL_TILE * LD;
  float* vs = ks + ATL_TILE * LD;
  float* ps = vs + ATL_TILE * LD;
  int* msk = reinterpret_cast<int*>(ps + ATL_TILE * ATL_PLD);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int nqt = (a.s_q + ATL_TILE - 1) / ATL_TILE;
  const int bh = blockIdx.x / nqt, i0 = (blockIdx.x - bh * nqt) * ATL_TILE;
  const int b = bh / a.nh, h = bh - b * a.nh;
  const size_t col = (size_t)h * a.hd;
  const T* kb = a.k + (size_t)b * a.s_k * a.kv_ld + col;
  const T* vb = a.v + (size_t)b * a.s_k * a.kv_ld + col;

  atl_start(atl_smem, 3 * ATL_TILE * LD + ATL_TILE * ATL_PLD, msk, a, b);
  atl_load<T>(qs, LD, a.q + (size_t)b * a.s_q * a.q_ld + col, a.q_ld, i0, a.s_q, a.hd);

  // sweep 1: each row's max and sum of exp over the real keys, online
  float m[4], z[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = -INFINITY, z[r] = 0.0f;
  for (int j0 = 0; j0 < a.s_k; j0 += ATL_TILE) {
    __syncthreads();
    atl_load<T>(ks, LD, kb, a.kv_ld, j0, a.s_k, a.hd);
    __syncthreads();
    float s[4][8] = {};
    atl_abt<8>(s, qs, LD, ks, LD, a.hd, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + tx + 8 * c;
        if (j < a.s_k) {
          s[r][c] = atl_score<WHERE_MASK>(s[r][c], i, j, a, msk);
          mx = fmaxf(mx, s[r][c]);
        }
      }
      const float mn = fmaxf(m[r], atl_row_max(mx));  // finite: the tile has a real key
      float e = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (j0 + tx + 8 * c < a.s_k) e += expf(s[r][c] - mn);
      z[r] = z[r] * expf(m[r] - mn) + atl_row_sum(e);
      m[r] = mn;
    }
  }

  // sweep 2: p = e / z (#13: e * (1 / z)) times the keep mask, rounded, then p V
  float o[4][NC] = {};
  for (int j0 = 0; j0 < a.s_k; j0 += ATL_TILE) {
    __syncthreads();
    atl_load<T>(ks, LD, kb, a.kv_ld, j0, a.s_k, a.hd);
    atl_load<T>(vs, LD, vb, a.kv_ld, j0, a.s_k, a.hd);
    __syncthreads();
    float s[4][8] = {};
    atl_abt<8>(s, qs, LD, ks, LD, a.hd, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      const float inv_z = 1.0f / z[r];
      const uint32_t rt = dropout_row_term(b * a.s_q + i, a.op_base + h, a.drop.seed);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + tx + 8 * c;
        float p = 0.0f;
        if (j < a.s_k) {
          const float e = expf(atl_score<WHERE_MASK>(s[r][c], i, j, a, msk) - m[r]);
          if constexpr (WHERE_MASK) {
            p = e * inv_z;
          } else {
            p = e / z[r];
            if (a.drop.on) p *= dropout_keep(rt, j, a.drop);
          }
        }
        ps[(ty + 16 * r) * ATL_PLD + tx + 8 * c] = AtlIO<T>::round(p);
      }
    }
    __syncthreads();
    atl_ab<NC>(o, ps, ATL_PLD, vs, LD, ty, tx);
  }
  atl_store<T, NC>(a.out + (size_t)b * a.s_q * a.out_ld + col, a.out_ld, o, i0, a.s_q, a.hd, ty,
                   tx);
}

// Backward: block (sentence, head); dq by query tiles, then dk and dv by key
// tiles, from each query row's max, sum of exp and t kept in shared memory.
template <typename T, int NC>
__global__ void __launch_bounds__(ATL_THREADS) attention_long_bwd_kernel(AttnArgs<T> a) {
  extern __shared__ __align__(16) float atl_smem[];
  constexpr int LD = 8 * NC + 1;
  float* qs = atl_smem;
  float* gs = qs + ATL_TILE * LD;
  float* ks = gs + ATL_TILE * LD;
  float* vs = ks + ATL_TILE * LD;
  float* t1 = vs + ATL_TILE * LD;  // ds (dq pass); p kappa (dk / dv pass)
  float* t2 = t1 + ATL_TILE * ATL_PLD;  // ds (dk / dv pass)
  float* st_m = t2 + ATL_TILE * ATL_PLD;
  float* st_z = st_m + ATL_MAX_S;
  float* st_t = st_z + ATL_MAX_S;
  int* msk = reinterpret_cast<int*>(st_t + ATL_MAX_S);
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int b = blockIdx.x / a.nh, h = blockIdx.x - b * a.nh;
  const size_t col = (size_t)h * a.hd;
  const int H = a.nh * a.hd;
  const T* qb = a.q + (size_t)b * a.s_q * a.q_ld + col;
  const T* gb = a.g + (size_t)b * a.s_q * H + col;
  const T* kb = a.k + (size_t)b * a.s_k * a.kv_ld + col;
  const T* vb = a.v + (size_t)b * a.s_k * a.kv_ld + col;
  const uint32_t op = a.op_base + h;

  atl_start(atl_smem, 4 * ATL_TILE * LD + 2 * ATL_TILE * ATL_PLD, msk, a, b);

  for (int i0 = 0; i0 < a.s_q; i0 += ATL_TILE) {
    __syncthreads();
    atl_load<T>(qs, LD, qb, a.q_ld, i0, a.s_q, a.hd);
    atl_load<T>(gs, LD, gb, H, i0, a.s_q, a.hd);

    // sweep 1: max, sum of exp and the sum of e * dp * kappa, online
    float m[4], z[4], tau[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) m[r] = -INFINITY, z[r] = 0.0f, tau[r] = 0.0f;
    for (int j0 = 0; j0 < a.s_k; j0 += ATL_TILE) {
      __syncthreads();
      atl_load<T>(ks, LD, kb, a.kv_ld, j0, a.s_k, a.hd);
      atl_load<T>(vs, LD, vb, a.kv_ld, j0, a.s_k, a.hd);
      __syncthreads();
      float s[4][8] = {}, dp[4][8] = {};
      atl_abt<8>(s, qs, LD, ks, LD, a.hd, ty, tx);
      atl_abt<8>(dp, gs, LD, vs, LD, a.hd, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = j0 + tx + 8 * c;
          if (j < a.s_k) {
            s[r][c] = atl_score<false>(s[r][c], i, j, a, msk);
            mx = fmaxf(mx, s[r][c]);
          }
        }
        const float mn = fmaxf(m[r], atl_row_max(mx));
        float se = 0.0f, sd = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = j0 + tx + 8 * c;
          if (j < a.s_k) {
            const float e = expf(s[r][c] - mn);
            float d = dp[r][c];
            if (a.drop.on) d *= dropout_keep(rt, j, a.drop);
            se += e;
            sd += e * d;
          }
        }
        const float al = expf(m[r] - mn);
        z[r] = z[r] * al + atl_row_sum(se);
        tau[r] = tau[r] * al + atl_row_sum(sd);
        m[r] = mn;
      }
    }
    float t[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      t[r] = tau[r] / z[r];
      if (tx == 0 && i < a.s_q) st_m[i] = m[r], st_z[i] = z[r], st_t[i] = t[r];
    }

    // sweep 2: ds = p (dp kappa - t) * scale, rounded; dq += ds K
    float dq[4][NC] = {};
    for (int j0 = 0; j0 < a.s_k; j0 += ATL_TILE) {
      __syncthreads();
      atl_load<T>(ks, LD, kb, a.kv_ld, j0, a.s_k, a.hd);
      atl_load<T>(vs, LD, vb, a.kv_ld, j0, a.s_k, a.hd);
      __syncthreads();
      float s[4][8] = {}, dp[4][8] = {};
      atl_abt<8>(s, qs, LD, ks, LD, a.hd, ty, tx);
      atl_abt<8>(dp, gs, LD, vs, LD, a.hd, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = j0 + tx + 8 * c;
          float ds = 0.0f;
          if (i < a.s_q && j < a.s_k) {
            const float p = expf(atl_score<false>(s[r][c], i, j, a, msk) - m[r]) / z[r];
            float d = dp[r][c];
            if (a.drop.on) d *= dropout_keep(rt, j, a.drop);
            ds = p * (d - t[r]) * a.scale;
          }
          t1[(ty + 16 * r) * ATL_PLD + tx + 8 * c] = AtlIO<T>::round(ds);
        }
      }
      __syncthreads();
      atl_ab<NC>(dq, t1, ATL_PLD, ks, LD, ty, tx);
    }
    atl_store<T, NC>(a.out + (size_t)b * a.s_q * a.out_ld + col, a.out_ld, dq, i0, a.s_q, a.hd,
                     ty, tx);
  }

  // dk = ds^T Q and dv = (p kappa)^T G: key rows, the sums over the queries
  for (int j0 = 0; j0 < a.s_k; j0 += ATL_TILE) {
    __syncthreads();  // also: every row's statistics are kept
    atl_load<T>(ks, LD, kb, a.kv_ld, j0, a.s_k, a.hd);
    atl_load<T>(vs, LD, vb, a.kv_ld, j0, a.s_k, a.hd);
    float dk[4][NC] = {}, dv[4][NC] = {};
    for (int i0 = 0; i0 < a.s_q; i0 += ATL_TILE) {
      __syncthreads();
      atl_load<T>(qs, LD, qb, a.q_ld, i0, a.s_q, a.hd);
      atl_load<T>(gs, LD, gb, H, i0, a.s_q, a.hd);
      __syncthreads();
      float s[4][8] = {}, dp[4][8] = {};
      atl_abt<8>(s, ks, LD, qs, LD, a.hd, ty, tx);
      atl_abt<8>(dp, vs, LD, gs, LD, a.hd, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = j0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int i = i0 + tx + 8 * c;
          float pk = 0.0f, ds = 0.0f;
          if (j < a.s_k && i < a.s_q) {
            const float p = expf(atl_score<false>(s[r][c], i, j, a, msk) - st_m[i]) / st_z[i];
            float d = dp[r][c], kap = 1.0f;
            if (a.drop.on) {
              kap = dropout_keep(dropout_row_term(b * a.s_q + i, op, a.drop.seed), j, a.drop);
              d *= kap;
            }
            pk = a.drop.on ? p * kap : p;
            ds = p * (d - st_t[i]) * a.scale;
          }
          t1[(ty + 16 * r) * ATL_PLD + tx + 8 * c] = AtlIO<T>::round(pk);
          t2[(ty + 16 * r) * ATL_PLD + tx + 8 * c] = AtlIO<T>::round(ds);
        }
      }
      __syncthreads();
      atl_ab<NC>(dv, t1, ATL_PLD, gs, LD, ty, tx);
      atl_ab<NC>(dk, t2, ATL_PLD, qs, LD, ty, tx);
    }
    atl_store<T, NC>(a.dk + (size_t)b * a.s_k * a.dkv_ld + col, a.dkv_ld, dk, j0, a.s_k, a.hd, ty,
                     tx);
    atl_store<T, NC>(a.dv + (size_t)b * a.s_k * a.dkv_ld + col, a.dkv_ld, dv, j0, a.s_k, a.hd, ty,
                     tx);
  }
}

// what every attention entry takes: attention.cuh's and attention_f32.cuh's
// kernels up to 32 queries and keys, this file's beyond, up to 512
inline bool attention_fits(int s_q, int s_k, int hd) {
  return s_q >= 1 && s_k >= 1 && s_q <= ATL_MAX_S && s_k <= ATL_MAX_S && hd >= 1 &&
         hd <= ATL_MAX_HD;
}

// Launches KERNEL on grid blocks with its shared memory, raising the
// kernel's limit once per device.
template <typename T, void (*KERNEL)(AttnArgs<T>)>
int atl_launch(const AttnArgs<T>& a, int grid, int bytes, cudaStream_t st) {
  static unsigned configured = 0;  // a bit per device whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 32 || !(configured >> dev & 1u)) {
    e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 32) configured |= 1u << dev;
  }
  KERNEL<<<grid, ATL_THREADS, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The forward of a (batch, nh) call with s_q or s_k above 32.
template <typename T, bool WHERE_MASK>
int attention_long_fwd(const AttnArgs<T>& a, cudaStream_t st) {
  if (!attention_fits(a.s_q, a.s_k, a.hd)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch * a.nh <= 0) return 0;
  const int grid = a.batch * a.nh * ((a.s_q + ATL_TILE - 1) / ATL_TILE);
  if (a.hd <= 64)
    return atl_launch<T, attention_long_kernel<T, WHERE_MASK, 8>>(a, grid,
                                                                  atl_smem_bytes(8, false), st);
  return atl_launch<T, attention_long_kernel<T, WHERE_MASK, 16>>(a, grid,
                                                                 atl_smem_bytes(16, false), st);
}

// The backward of a (batch, nh) call with s_q or s_k above 32.
template <typename T>
int attention_long_bwd(const AttnArgs<T>& a, cudaStream_t st) {
  if (!attention_fits(a.s_q, a.s_k, a.hd)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch * a.nh <= 0) return 0;
  const int grid = a.batch * a.nh;
  if (a.hd <= 64)
    return atl_launch<T, attention_long_bwd_kernel<T, 8>>(a, grid, atl_smem_bytes(8, true), st);
  return atl_launch<T, attention_long_bwd_kernel<T, 16>>(a, grid, atl_smem_bytes(16, true), st);
}

}  // namespace
