// Attention of sentences longer than 32 tokens (up to 512 queries and 512
// keys), and of heads wider than 128 columns at any length, forward and
// backward, in bf16 and in f32, for Hopper (sm_90a): the kernels behind
// attention_long.cuh's entries, which attention.cuh (bf16) and
// attention_f32.cuh (f32) call past their one-warp-per-(sentence, head)
// kernels, so every attention entry reaches
// them (the layer kernels #1, #3 / #4 inside #2; sdpa.cu #11, #12, #13). They
// replace, at these lengths, the same TPU attention as attention.cuh
// (kindergarten_vq_vae_tpu/ops/): layer_pallas.py:244 `_attn_fwd_tile`
// (inside `_layer_fwd_kernel` l.489), l.696 `_attn_bwd_self_kernel`, l.712
// `_attn_bwd_cross_kernel`, sdpa_pallas.py:103 `_sdpa_fwd_kernel`, l.142
// `_sdpa_bwd_kernel` and attention_pallas.py:65 `_mha_kernel`, which take
// any sequence length. The function and its rounding points are written in
// attention_long.cuh.
//
// Design: 64-row tiles of queries or keys, a block of 4 warps, each warp
// owning 16 rows of its block's tile, every product on the tensor cores:
// - bf16: mma.sync m16n8k16 (f32 accumulate) on ldmatrix fragments, the
//   transposed operands through ldmatrix.trans (attention.cuh's fragments);
//   f32: 3xTF32 mma.sync m16n8k8 (attention_f32.cuh's mma3 and fragments).
//   Scores land in the accumulator registers, where the masks, the softmax
//   and the dropout keep mask run with quad shuffles for the row max and
//   sums; p (or ds, or p kappa) then goes from the accumulator straight into
//   the A fragment of the next product, rounded to the compute dtype there.
//   p = e / z and t are layer_common.cuh's div_rn / rcp_rn: the division's
//   bits without its slow-path call, around which ptxas spilled registers;
// - tiles are staged in the compute dtype (bf16 stays bf16) with 16-byte
//   cp.async where every pointer, row stride and head_dim allows it (else
//   element copies), at a row stride of head_dim padded to 64 or 128 plus 16
//   bytes (ldmatrix free of bank conflicts); rows past the sentence are
//   zero-filled, padded columns zeroed once. The first tiles' loads start
//   before the key mask is read, and V (and g) load behind the first product;
// - up to 64 keys (the 64-token step) a row's 64 scores stay in registers:
//   one sweep takes the max, the sum and p. Past that, a first sweep over
//   32-key chunks keeps each row's max and sum online and a second
//   recomputes the scores for p with the final ones (p's rounding point
//   needs them). The streamed tiles go through two slots, the next tile's
//   loads behind this tile's math; up to 128 keys they are loaded once and
//   kept for both sweeps. (A persistent forward that loaded the next unit
//   behind this one's math measured 25-31% slower on an H100: more
//   registers, fewer blocks an SM);
// - under the causal mask a query tile skips the key tiles wholly above its
//   last row's diagonal (and a key tile the query tiles wholly below its
//   first row's) only when each of the tile's rows has a real key at or
//   before it: their scores carry NEG_INF, so exp gives exactly 0. A row
//   with no such key (a fully masked sentence) is near uniform over all s_k
//   keys, as in the plain version, and sweeps them all;
// - forward (attention_long_kernel): a block a (sentence, head, query
//   tile); the output is staged in the warp's spent q rows and written with
//   16-byte stores;
// - backward, two launches whose grids both grow with the sentence and
//   that sum nothing across blocks: attention_long_dq_kernel, a block a
//   (sentence, head, query tile), takes each row's max, sum z and t (the sum
//   of e * dp * kappa over z), writes (m, z, 1 / z, t) to the f32 scratch
//   AttnArgs::stats and adds ds K into dq; attention_long_dkv_kernel, a
//   block a (sentence, head, key tile), sweeps the query tiles with their
//   (m, z, 1 / z, t) and adds (p kappa)^T G into dv and ds^T Q into dk, the
//   scores computed as K Q^T (key rows), so that both come from the
//   accumulators as A fragments. Every sum runs in a fixed order: two
//   launches give the same bits;
// - head_dim past 128 (attention_wide_kernel, attention_wide_dq_kernel,
//   attention_wide_dkv_kernel, below), at every length: 128-column chunks,
//   the scores summed over the chunks; up to 64 keys (queries) a block
//   keeps them in registers for every output chunk, past that a block
//   takes one output chunk and recomputes them in the two sweeps.
// What bounds it: the bytes. At 64 tokens x 64 head_dim a (sentence, head)
// moves ~32 KB in the forward (q, k, v read, ctx written, bf16) for ~1.6
// MFLOP of products (3 of 64 x 64 x 64), ~50 FLOP a byte, far below the 295
// where the tensor cores would bind; the backward reads q, k, v, g in both
// launches and does 9 products. What holds it above the byte bound is each
// block's chain of loads, products and per-element work (exp, the division,
// the dropout hash) with about four blocks an SM; PERF.md has the times.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "attention_f32.cuh"  // attention.cuh's and attention_f32.cuh's fragments
#include "attention_long.cuh"
#include "dropout_hash.cuh"
#include "layer_common.cuh"

namespace {

using namespace kvq;

constexpr int ATL_TILE = 64;      // rows of queries or keys a tile
constexpr int ATL_THREADS = 128;  // 4 warps, 16 rows of a tile each
constexpr int ATL_CH = 4;         // n8 tiles of a chunk: 32 keys (or queries) of scores a step
constexpr int ATL_MASK_BYTES = (ATL_MAX_S + 4) * 4;  // the key mask, then a first key a warp
constexpr int ATL_VEC = 1, ATL_WHERE_MASK = 2;       // the kernels' flags

__host__ __device__ constexpr int atl_tiles(int rows) { return (rows + ATL_TILE - 1) / ATL_TILE; }

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp's products on its 16 rows. T: the compute dtype; D: head_dim
// padded to 64 or 128; tiles row-major at row stride LD.
template <typename T, int D>
struct Atl;

template <int D>
struct Atl<bf16, D> {
  static constexpr int LD = D + 8;

  // acc[n] += A[0..15][0..D) . B[8 n..8 n + 7][0..D)^T
  template <int NT>
  __device__ __forceinline__ static void abt(float (&acc)[NT][4], const bf16* A, const bf16* B,
                                             int lane) {
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t af[4];
      ldsm_x4(af, A + (lane & 15) * LD + d0 + (lane >> 4) * 8);
#pragma unroll
      for (int kt = 0; kt < NT / 2; ++kt) {
        uint32_t bfr[4];  // n8 tiles 2 kt and 2 kt + 1
        ldsm_x4(bfr, B + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + d0 +
                         (((lane >> 3) & 1) << 3));
        mma_bf16(acc[2 * kt], af, bfr[0], bfr[1]);
        mma_bf16(acc[2 * kt + 1], af, bfr[2], bfr[3]);
      }
    }
  }

  // o[n] += bf16(p)[0..15][0..8 NT) . X[0..8 NT)[8 n..8 n + 7], p from the
  // accumulator registers, X (rows = the sum's index) through ldmatrix.trans
  template <int NT>
  __device__ __forceinline__ static void mix(float (&o)[D / 8][4], const float (&p)[NT][4],
                                             const bf16* X, int lane) {
#pragma unroll
    for (int kt = 0; kt < NT / 2; ++kt) {
      uint32_t a[4];
      att_c_to_a(a, p, kt);
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += 16) {
        uint32_t b[4];
        att_b_trans(b, X, LD, kt * 16, d0, lane);
        mma_bf16(o[d0 / 8], a, b[0], b[1]);
        mma_bf16(o[d0 / 8 + 1], a, b[2], b[3]);
      }
    }
  }

  __device__ __forceinline__ static void put(bf16* dst, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
  }
};

template <int D>
struct Atl<float, D> {
  static constexpr int LD = D + 4;  // also: attf_b_pairs' rows 2t on banks 8 apart

  template <int NT>
  __device__ __forceinline__ static void abt(float (&acc)[NT][4], const float* A, const float* B,
                                             int lane) {
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 8) {
      FragA af;
      attf_a_rows(af, A, LD, 0, d0, lane);
#pragma unroll
      for (int kt = 0; kt < NT / 2; ++kt) {
        FragB bf[2];
        attf_b_rows(bf, B, LD, kt * 16, d0, lane);
        mma3(acc[2 * kt], af, bf[0]);
        mma3(acc[2 * kt + 1], af, bf[1]);
      }
    }
  }

  template <int NT>
  __device__ __forceinline__ static void mix(float (&o)[D / 8][4], const float (&p)[NT][4],
                                             const float* X, int lane) {
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      FragA a;
      attf_c_to_a(a, p[ks]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB b;
        attf_b_pairs(b, X, LD, ks * 8, n * 8, lane);
        mma3(o[n], a, b);
      }
    }
  }

  __device__ __forceinline__ static void put(float* dst, float v0, float v1) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  }
};

template <typename T, int D>
constexpr int atl_tile_bytes() {
  return ATL_TILE * Atl<T, D>::LD * static_cast<int>(sizeof(T));
}

// rows row0 .. row0 + 63 of src (hd columns at row stride ld; rows at or
// past `rows` zero) into a tile at row stride LD
template <typename T, int LD>
__device__ __forceinline__ void atl_tile(T* dst, const T* src, int ld, int row0, int rows, int hd,
                                         bool vec) {
  if (vec) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    const int cpr = hd / E;
    for (int c = threadIdx.x; c < ATL_TILE * cpr; c += ATL_THREADS) {
      const int r = c / cpr, col = (c - r * cpr) * E, row = row0 + r;
      const bool in = row < rows;
      cp_async16(dst + r * LD + col, src + (size_t)(in ? row : 0) * ld + col, in);
    }
  } else {
    for (int e = threadIdx.x; e < ATL_TILE * hd; e += ATL_THREADS) {
      const int r = e / hd, col = e - r * hd, row = row0 + r;
      dst[r * LD + col] = row < rows ? src[(size_t)row * ld + col] : static_cast<T>(0.0f);
    }
  }
}

// a warp's 16 accumulator rows (o) into its 16 tile rows, in T
template <typename T, int D>
__device__ __forceinline__ void atl_stage(T* rows, const float (&o)[D / 8][4], int lane) {
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      Atl<T, D>::put(rows + (g8 + 8 * r) * Atl<T, D>::LD + 8 * n + 2 * t4, o[n][2 * r],
                     o[n][2 * r + 1]);
}

// a warp's 16 staged tile rows (src, row stride LD) out to rows row0.. of
// dst (row stride ld), those below `rows`
template <typename T, int LD>
__device__ __forceinline__ void atl_store(T* dst, int ld, const T* src, int row0, int rows, int hd,
                                          bool vec, int lane) {
  if (vec) {
    constexpr int E = 16 / static_cast<int>(sizeof(T));
    const int cpr = hd / E;
    for (int c = lane; c < 16 * cpr; c += 32) {
      const int r = c / cpr, col = (c - r * cpr) * E;
      if (row0 + r < rows)
        *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * ld + col) =
            *reinterpret_cast<const uint4*>(src + r * LD + col);
    }
  } else {
    for (int e = lane; e < 16 * hd; e += 32) {
      const int r = e / hd, col = e - r * hd;
      if (row0 + r < rows) dst[(size_t)(row0 + r) * ld + col] = src[r * LD + col];
    }
  }
}

__device__ __forceinline__ void atl_zero(void* base, int bytes) {
  uint4* p = static_cast<uint4*>(base);
  for (int i = threadIdx.x; i < bytes / 16; i += ATL_THREADS) p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The sentence's key mask into msk (1 for every key without one); returns
// its first real key (s_k if none). Ends with a barrier.
template <typename T>
__device__ __forceinline__ int atl_mask(int* msk, const AttnArgs<T>& a, int b) {
  int first = a.s_k;
  for (int j = threadIdx.x; j < a.s_k; j += ATL_THREADS) {
    const int m = a.key_mask == nullptr ? 1 : a.key_mask[(size_t)b * a.s_k + j];
    msk[j] = m;
    if (m > 0 && first == a.s_k) first = j;
  }
  first = __reduce_min_sync(0xffffffffu, first);
  int* firsts = msk + ATL_MAX_S;
  if ((threadIdx.x & 31) == 0) firsts[threadIdx.x >> 5] = first;
  __syncthreads();
  return min(min(firsts[0], firsts[1]), min(firsts[2], firsts[3]));
}

// The masked, scaled score (ok: key valid and not above the causal diagonal)
__device__ __forceinline__ float atl_x(float acc, bool ok, float scale, bool where_mask) {
  if (where_mask) return ok ? acc * scale : NEG_INF;
  return acc * scale + (ok ? 0.0f : NEG_INF);
}

// The key tiles a query tile at i0 sweeps: all, or under the causal mask
// those up to its last row's diagonal when each of its rows has a real key
// at or before it (first: the sentence's first real key).
template <typename T>
__device__ __forceinline__ int atl_key_tiles(const AttnArgs<T>& a, int i0, int first) {
  const int n = atl_tiles(a.s_k);
  if (!a.causal || first >= a.s_k || first > i0) return n;
  return min(n, (min(i0 + ATL_TILE, a.s_q) - 1) / ATL_TILE + 1);
}

// Row r of a warp's scores sc (NT n8 tiles from key 0 of a one-tile sweep)
// into p in place: the masks and scale, the row max over the real keys, e =
// exp(x - max), z = the row sum, p = e / z (#13: e * (1 / z)) times the keep
// mask. i: the query row.
template <int NT, typename T>
__device__ __forceinline__ void atl_probs(float (&sc)[NT][4], int r, int i, const AttnArgs<T>& a,
                                          const int* msk, bool wm, int b, uint32_t op, int t4) {
  float mx = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = nt * 8 + 2 * t4 + c;
      float x = -INFINITY;
      if (j < a.s_k) {
        x = atl_x(sc[nt][2 * r + c], msk[j] > 0 && !(a.causal && j > i), a.scale, wm);
        mx = fmaxf(mx, x);
      }
      sc[nt][2 * r + c] = x;
    }
  mx = quad_max(mx);
  float z = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float e = expf(sc[nt][2 * r + c] - mx);  // 0 past s_k
      sc[nt][2 * r + c] = e;
      z += e;
    }
  z = quad_sum(z);
  const float inv_z = rcp_rn(z);
  const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = nt * 8 + 2 * t4 + c;
      float p = 0.0f;
      if (j < a.s_k) {
        const float e = sc[nt][2 * r + c];
        if (wm) {
          p = e * inv_z;
        } else {
          p = div_rn(e, z, inv_z);
          if (a.drop.on) p *= dropout_keep(rt, j, a.drop);
        }
      }
      sc[nt][2 * r + c] = p;
    }
}

// Forward: block (sentence, head, query tile).
template <typename T, int D>
__global__ void __launch_bounds__(ATL_THREADS) attention_long_kernel(AttnArgs<T> a, int flags) {
  using M = Atl<T, D>;
  constexpr int LD = M::LD, TILE = ATL_TILE * LD;
  extern __shared__ __align__(16) unsigned char atl_smem[];
  const bool vec = flags & ATL_VEC, wm = flags & ATL_WHERE_MASK;
  const int nqt = atl_tiles(a.s_q), slots = min(atl_tiles(a.s_k), 2);
  T* qs = reinterpret_cast<T*>(atl_smem);
  T* kvs = qs + TILE;  // slot x: its K tile at kvs + 2 x TILE, its V tile after it
  int* msk = reinterpret_cast<int*>(kvs + 2 * slots * TILE);
  const int bh = blockIdx.x / nqt, i0 = (blockIdx.x - bh * nqt) * ATL_TILE;
  const int b = bh / a.nh, h = bh - b * a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const size_t col = (size_t)h * a.hd;
  const T* kb = a.k + (size_t)b * a.s_k * a.kv_ld + col;
  const T* vb = a.v + (size_t)b * a.s_k * a.kv_ld + col;

  if (a.hd < D) {
    atl_zero(atl_smem, (1 + 2 * slots) * TILE * static_cast<int>(sizeof(T)));
    __syncthreads();
  }
  // step 0, whatever the mask: q and key tile 0's K, then its V, into slot 0
  atl_tile<T, LD>(qs, a.q + (size_t)b * a.s_q * a.q_ld + col, a.q_ld, i0, a.s_q, a.hd, vec);
  atl_tile<T, LD>(kvs, kb, a.kv_ld, 0, a.s_k, a.hd, vec);
  cp_commit();
  atl_tile<T, LD>(kvs + TILE, vb, a.kv_ld, 0, a.s_k, a.hd, vec);
  cp_commit();
  const int n = atl_key_tiles(a, i0, atl_mask(msk, a, b));
  const bool kept = n <= 2;  // every key tile stays in its slot for both sweeps
  // step s < n: key tile s for the max and sum; s >= n: key tile s - n for p V
  auto slot = [&](int s) { return kvs + 2 * (kept ? s % n : s & 1) * TILE; };
  auto issue = [&](int s) {
    if (s < 2 * n) {
      const int row0 = (s % n) * ATL_TILE, sweep = s / n;
      if (!kept || sweep == 0) atl_tile<T, LD>(slot(s), kb, a.kv_ld, row0, a.s_k, a.hd, vec);
      if (kept ? sweep == 0 : sweep == 1)
        atl_tile<T, LD>(slot(s) + TILE, vb, a.kv_ld, row0, a.s_k, a.hd, vec);
    }
    cp_commit();
  };

  T* qw = qs + warp * 16 * LD;  // this warp's query rows
  const int iw = i0 + warp * 16 + g8;  // its rows iw and iw + 8
  const uint32_t op = a.op_base + h;
  float o[D / 8][4] = {};
  if (n == 1) {
    // one key tile: its scores once, in registers (V still loading), then p V
    cp_wait<1>();
    __syncthreads();
    float sc[ATL_TILE / 8][4] = {};
    M::template abt<ATL_TILE / 8>(sc, qw, kvs, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) atl_probs(sc, r, iw + 8 * r, a, msk, wm, b, op, t4);
    cp_wait<0>();
    __syncthreads();
    M::template mix<ATL_TILE / 8>(o, sc, kvs + TILE, lane);
  } else {
    float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.0f, 0.0f};
    for (int s = 0; s < 2 * n; ++s) {
      issue(s + 1);
      cp_wait<1>();
      __syncthreads();
      const T* ks = slot(s);
#pragma unroll 1
      for (int c0 = 0; c0 < ATL_TILE; c0 += 8 * ATL_CH) {
        const int jc = (s % n) * ATL_TILE + c0;
        if (jc >= a.s_k) break;
        float sc[ATL_CH][4] = {};
        M::template abt<ATL_CH>(sc, qw, ks + c0 * LD, lane);
        if (s < n) {
          // each row's max and sum of exp over the real keys, online
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = iw + 8 * r;
            float mx = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < ATL_CH; ++nt)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int j = jc + nt * 8 + 2 * t4 + c;
                float x = -INFINITY;
                if (j < a.s_k) {
                  x = atl_x(sc[nt][2 * r + c], msk[j] > 0 && !(a.causal && j > i), a.scale, wm);
                  mx = fmaxf(mx, x);
                }
                sc[nt][2 * r + c] = x;
              }
            const float mn = fmaxf(m[r], quad_max(mx));  // finite: the chunk has a real key
            float e = 0.0f;
#pragma unroll
            for (int nt = 0; nt < ATL_CH; ++nt)
#pragma unroll
              for (int c = 0; c < 2; ++c) e += expf(sc[nt][2 * r + c] - mn);  // 0 past s_k
            z[r] = z[r] * expf(m[r] - mn) + quad_sum(e);
            m[r] = mn;
          }
        } else {
          // p = e / z (#13: e * (1 / z)) with the final max and sum, times the
          // keep mask, then p V
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = iw + 8 * r;
            const float inv_z = rcp_rn(z[r]);
            const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
#pragma unroll
            for (int nt = 0; nt < ATL_CH; ++nt)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int j = jc + nt * 8 + 2 * t4 + c;
                float p = 0.0f;
                if (j < a.s_k) {
                  const bool ok = msk[j] > 0 && !(a.causal && j > i);
                  const float e = expf(atl_x(sc[nt][2 * r + c], ok, a.scale, wm) - m[r]);
                  if (wm) {
                    p = e * inv_z;
                  } else {
                    p = div_rn(e, z[r], inv_z);
                    if (a.drop.on) p *= dropout_keep(rt, j, a.drop);
                  }
                }
                sc[nt][2 * r + c] = p;
              }
          }
          M::template mix<ATL_CH>(o, sc, ks + TILE + c0 * LD, lane);
        }
      }
      __syncthreads();  // the slot is free for step s + 2's loads
    }
  }
  atl_stage<T, D>(qw, o, lane);
  __syncwarp();
  atl_store<T, LD>(a.out + (size_t)b * a.s_q * a.out_ld + col, a.out_ld, qw, i0 + warp * 16,
                   a.s_q, a.hd, vec, lane);
}

// Backward, dq: block (sentence, head, query tile). Writes each query row's
// (max, sum of exp z, 1 / z, t) to a.stats for attention_long_dkv_kernel.
template <typename T, int D>
__global__ void __launch_bounds__(ATL_THREADS) attention_long_dq_kernel(AttnArgs<T> a, int flags) {
  using M = Atl<T, D>;
  constexpr int LD = M::LD, TILE = ATL_TILE * LD;
  extern __shared__ __align__(16) unsigned char atl_smem[];
  const bool vec = flags & ATL_VEC;
  const int nqt = atl_tiles(a.s_q), slots = min(atl_tiles(a.s_k), 2);
  T* qs = reinterpret_cast<T*>(atl_smem);
  T* gs = qs + TILE;
  T* kvs = gs + TILE;  // slot x: K at kvs + 2 x TILE, V after it
  int* msk = reinterpret_cast<int*>(kvs + 2 * slots * TILE);
  const int bh = blockIdx.x / nqt, i0 = (blockIdx.x - bh * nqt) * ATL_TILE;
  const int b = bh / a.nh, h = bh - b * a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  // the sentence's rows of head h in k or v, from ints: a 64-bit base kept
  // live across the kernel made ptxas spill
  auto kv_rows = [&](const T* base) { return base + ((size_t)b * a.s_k * a.kv_ld + h * a.hd); };

  if (a.hd < D) {
    atl_zero(atl_smem, (2 + 2 * slots) * TILE * static_cast<int>(sizeof(T)));
    __syncthreads();
  }
  auto slot = [&](int s, int n) { return kvs + 2 * (n <= 2 ? s % n : s & 1) * TILE; };
  auto issue = [&](int s, int n) {  // both sweeps take key tile s % n's K and V; n <= 2: kept
    if (s < 2 * n && (n > 2 || s < n)) {
      const int row0 = (s % n) * ATL_TILE;
      atl_tile<T, LD>(slot(s, n), kv_rows(a.k), a.kv_ld, row0, a.s_k, a.hd, vec);
      atl_tile<T, LD>(slot(s, n) + TILE, kv_rows(a.v), a.kv_ld, row0, a.s_k, a.hd, vec);
    }
    cp_commit();
  };
  // step 0, whatever the mask: q and key tile 0's K, then g and its V, into slot 0
  atl_tile<T, LD>(qs, a.q + ((size_t)b * a.s_q * a.q_ld + h * a.hd), a.q_ld, i0, a.s_q, a.hd,
                  vec);
  atl_tile<T, LD>(kvs, kv_rows(a.k), a.kv_ld, 0, a.s_k, a.hd, vec);
  cp_commit();
  atl_tile<T, LD>(gs, a.g + ((size_t)b * a.s_q * a.nh * a.hd + h * a.hd), a.nh * a.hd, i0,
                  a.s_q, a.hd, vec);
  atl_tile<T, LD>(kvs + TILE, kv_rows(a.v), a.kv_ld, 0, a.s_k, a.hd, vec);
  cp_commit();
  const int n = atl_key_tiles(a, i0, atl_mask(msk, a, b));

  const T* qw = qs + warp * 16 * LD;
  const T* gw = gs + warp * 16 * LD;
  const int iw = i0 + warp * 16 + g8;
  const uint32_t op = a.op_base + h;
  float dq[D / 8][4] = {};
  auto keep_stats = [&](int i, float m, float z, float rz, float t) {
    if (t4 == 0 && i < a.s_q)
      *reinterpret_cast<float4*>(a.stats + ((size_t)bh * a.s_q + i) * 4) = make_float4(m, z, rz, t);
  };
  if (n == 1) {
    // one key tile: s and dp once, in registers; ds = p (dp kappa - t) *
    // scale, rounded; dq = ds K
    cp_wait<1>();
    __syncthreads();
    float sc[ATL_TILE / 8][4] = {}, dp[ATL_TILE / 8][4] = {};
    M::template abt<ATL_TILE / 8>(sc, qw, kvs, lane);
    cp_wait<0>();
    __syncthreads();
    M::template abt<ATL_TILE / 8>(dp, gw, kvs + TILE, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + 8 * r;
      const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < ATL_TILE / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = nt * 8 + 2 * t4 + c;
          float x = -INFINITY;
          if (j < a.s_k) {
            x = atl_x(sc[nt][2 * r + c], msk[j] > 0 && !(a.causal && j > i), a.scale, false);
            mx = fmaxf(mx, x);
          }
          sc[nt][2 * r + c] = x;
        }
      mx = quad_max(mx);
      float se = 0.0f, sd = 0.0f;
#pragma unroll
      for (int nt = 0; nt < ATL_TILE / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = nt * 8 + 2 * t4 + c;
          float e = 0.0f, d = 0.0f;
          if (j < a.s_k) {
            e = expf(sc[nt][2 * r + c] - mx);
            d = dp[nt][2 * r + c];
            if (a.drop.on) d *= dropout_keep(rt, j, a.drop);
          }
          se += e;
          sd += e * d;
          sc[nt][2 * r + c] = e;
          dp[nt][2 * r + c] = d;
        }
      const float z = quad_sum(se), rz = rcp_rn(z), t = div_rn(quad_sum(sd), z, rz);
      keep_stats(i, mx, z, rz, t);
#pragma unroll
      for (int nt = 0; nt < ATL_TILE / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = nt * 8 + 2 * t4 + c;
          const bool in = i < a.s_q && j < a.s_k;
          const float p = div_rn(sc[nt][2 * r + c], z, rz);
          sc[nt][2 * r + c] = in ? p * (dp[nt][2 * r + c] - t) * a.scale : 0.0f;
        }
    }
    M::template mix<ATL_TILE / 8>(dq, sc, kvs, lane);
  } else {
    // sweep 1: max, sum of exp and the sum of e * dp * kappa, online
    float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.0f, 0.0f}, tau[2] = {0.0f, 0.0f};
    for (int s = 0; s < n; ++s) {
      issue(s + 1, n);
      cp_wait<1>();
      __syncthreads();
      const T* ks = slot(s, n);
#pragma unroll 1
      for (int c0 = 0; c0 < ATL_TILE; c0 += 8 * ATL_CH) {
        const int jc = s * ATL_TILE + c0;
        if (jc >= a.s_k) break;
        float sc[ATL_CH][4] = {}, dp[ATL_CH][4] = {};
        M::template abt<ATL_CH>(sc, qw, ks + c0 * LD, lane);
        M::template abt<ATL_CH>(dp, gw, ks + TILE + c0 * LD, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = iw + 8 * r;
          const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < ATL_CH; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = jc + nt * 8 + 2 * t4 + c;
              float x = -INFINITY;
              if (j < a.s_k) {
                x = atl_x(sc[nt][2 * r + c], msk[j] > 0 && !(a.causal && j > i), a.scale, false);
                mx = fmaxf(mx, x);
              }
              sc[nt][2 * r + c] = x;
            }
          const float mn = fmaxf(m[r], quad_max(mx));
          float se = 0.0f, sd = 0.0f;
#pragma unroll
          for (int nt = 0; nt < ATL_CH; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = jc + nt * 8 + 2 * t4 + c;
              if (j < a.s_k) {
                const float e = expf(sc[nt][2 * r + c] - mn);
                float d = dp[nt][2 * r + c];
                if (a.drop.on) d *= dropout_keep(rt, j, a.drop);
                se += e;
                sd += e * d;
              }
            }
          const float al = expf(m[r] - mn);
          z[r] = z[r] * al + quad_sum(se);
          tau[r] = tau[r] * al + quad_sum(sd);
          m[r] = mn;
        }
      }
      __syncthreads();
    }
    float t[2], rz[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rz[r] = rcp_rn(z[r]);
      t[r] = div_rn(tau[r], z[r], rz[r]);
      keep_stats(iw + 8 * r, m[r], z[r], rz[r], t[r]);
    }

    // sweep 2: ds = p (dp kappa - t) * scale, rounded; dq += ds K
    for (int s = n; s < 2 * n; ++s) {
      issue(s + 1, n);
      cp_wait<1>();
      __syncthreads();
      const T* ks = slot(s, n);
#pragma unroll 1
      for (int c0 = 0; c0 < ATL_TILE; c0 += 8 * ATL_CH) {
        const int jc = (s - n) * ATL_TILE + c0;
        if (jc >= a.s_k) break;
        float sc[ATL_CH][4] = {}, dp[ATL_CH][4] = {};
        M::template abt<ATL_CH>(sc, qw, ks + c0 * LD, lane);
        M::template abt<ATL_CH>(dp, gw, ks + TILE + c0 * LD, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = iw + 8 * r;
          const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
#pragma unroll
          for (int nt = 0; nt < ATL_CH; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = jc + nt * 8 + 2 * t4 + c;
              float ds = 0.0f;
              if (i < a.s_q && j < a.s_k) {
                const bool ok = msk[j] > 0 && !(a.causal && j > i);
                const float p =
                    div_rn(expf(atl_x(sc[nt][2 * r + c], ok, a.scale, false) - m[r]), z[r], rz[r]);
                float d = dp[nt][2 * r + c];
                if (a.drop.on) d *= dropout_keep(rt, j, a.drop);
                ds = p * (d - t[r]) * a.scale;
              }
              sc[nt][2 * r + c] = ds;
            }
        }
        M::template mix<ATL_CH>(dq, sc, ks + c0 * LD, lane);
      }
      __syncthreads();
    }
  }
  T* dst = qs + warp * 16 * LD;  // the warp's spent q rows
  atl_stage<T, D>(dst, dq, lane);
  __syncwarp();
  atl_store<T, LD>(a.out + ((size_t)b * a.s_q * a.out_ld + h * a.hd), a.out_ld, dst,
                   i0 + warp * 16, a.s_q, a.hd, vec, lane);
}

// Backward, dk and dv: block (sentence, head, key tile), from the query
// rows' (max, sum of exp z, 1 / z, t) that attention_long_dq_kernel wrote.
template <typename T, int D>
__global__ void __launch_bounds__(ATL_THREADS) attention_long_dkv_kernel(AttnArgs<T> a,
                                                                           int flags) {
  using M = Atl<T, D>;
  constexpr int LD = M::LD, TILE = ATL_TILE * LD;
  extern __shared__ __align__(16) unsigned char atl_smem[];
  const bool vec = flags & ATL_VEC;
  const int nqt = atl_tiles(a.s_q), nkt = atl_tiles(a.s_k), slots = min(nqt, 2);
  T* ks = reinterpret_cast<T*>(atl_smem);
  T* vs = ks + TILE;
  T* qgs = vs + TILE;  // slot x: Q at qgs + 2 x TILE, G after it
  float* sts = reinterpret_cast<float*>(qgs + 2 * slots * TILE);  // slot x: 64 rows x 4
  int* msk = reinterpret_cast<int*>(sts + slots * ATL_TILE * 4);
  const int bh = blockIdx.x / nkt, j0 = (blockIdx.x - bh * nkt) * ATL_TILE;
  const int b = bh / a.nh, h = bh - b * a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const size_t col = (size_t)h * a.hd;
  const int H = a.nh * a.hd;
  const T* qb = a.q + (size_t)b * a.s_q * a.q_ld + col;
  const T* gb = a.g + (size_t)b * a.s_q * H + col;
  const float* stb = a.stats + (size_t)bh * a.s_q * 4;

  if (a.hd < D) {
    atl_zero(atl_smem, (2 + 2 * slots) * TILE * static_cast<int>(sizeof(T)));
    __syncthreads();
  }
  atl_tile<T, LD>(ks, a.k + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, j0, a.s_k, a.hd, vec);
  atl_tile<T, LD>(vs, a.v + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, j0, a.s_k, a.hd, vec);
  const int first = atl_mask(msk, a, b);
  // under the causal mask the query tiles [lo, lo + skip) give this key tile
  // nothing: wholly below its first row's diagonal, each of their rows with
  // a real key at or before it
  int lo = nqt, skip = 0;
  if (a.causal && first < a.s_k) {
    lo = (first + ATL_TILE - 1) / ATL_TILE;
    skip = max(0, min(nqt, j0 / ATL_TILE) - lo);
  }
  const int steps = nqt - skip;
  auto tile = [&](int s) { return s < lo ? s : s + skip; };
  auto issue = [&](int s) {
    if (s < steps) {
      const int x = s & 1, i0 = tile(s) * ATL_TILE, rows = min(ATL_TILE, a.s_q - i0);
      T* qd = qgs + 2 * x * TILE;
      atl_tile<T, LD>(qd, qb, a.q_ld, i0, a.s_q, a.hd, vec);
      atl_tile<T, LD>(qd + TILE, gb, H, i0, a.s_q, a.hd, vec);
      float* sd = sts + x * ATL_TILE * 4;
      for (int r = threadIdx.x; r < rows; r += ATL_THREADS)
        cp_async16(sd + 4 * r, stb + (size_t)(i0 + r) * 4, true);
    }
    cp_commit();
  };
  issue(0);

  T* kw = ks + warp * 16 * LD;  // this warp's key rows
  T* vw = vs + warp * 16 * LD;
  const int jw = j0 + warp * 16 + g8;  // its keys jw and jw + 8
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) valid[r] = jw + 8 * r < a.s_k && msk[jw + 8 * r] > 0;
  const uint32_t op = a.op_base + h;
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  for (int s = 0; s < steps; ++s) {
    issue(s + 1);
    cp_wait<1>();
    __syncthreads();
    const int i0 = tile(s) * ATL_TILE;
    const T* qsl = qgs + 2 * (s & 1) * TILE;
    const T* gsl = qsl + TILE;
    const float* st = sts + (s & 1) * ATL_TILE * 4;
#pragma unroll 1
    for (int c0 = 0; c0 < ATL_TILE; c0 += 8 * ATL_CH) {
      const int ic = i0 + c0;
      if (ic >= a.s_q) break;
      // p^T and dp^T: key rows, query columns
      float pt[ATL_CH][4] = {}, dpt[ATL_CH][4] = {};
      M::template abt<ATL_CH>(pt, kw, qsl + c0 * LD, lane);
      M::template abt<ATL_CH>(dpt, vw, gsl + c0 * LD, lane);
#pragma unroll
      for (int nt = 0; nt < ATL_CH; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = ic + nt * 8 + 2 * t4 + c;
          if (i >= a.s_q) {
            pt[nt][c] = pt[nt][2 + c] = dpt[nt][c] = dpt[nt][2 + c] = 0.0f;
            continue;
          }
          const float4 sr = *reinterpret_cast<const float4*>(st + (i - i0) * 4);  // m, z, 1 / z, t
          const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = jw + 8 * r;
            float pk = 0.0f, ds = 0.0f;
            if (j < a.s_k) {
              const bool ok = valid[r] && !(a.causal && j > i);
              const float p = div_rn(expf(atl_x(pt[nt][2 * r + c], ok, a.scale, false) - sr.x),
                                      sr.y, sr.z);
              float d = dpt[nt][2 * r + c], kap = 1.0f;
              if (a.drop.on) {
                kap = dropout_keep(rt, j, a.drop);
                d *= kap;
              }
              pk = a.drop.on ? p * kap : p;
              ds = p * (d - sr.w) * a.scale;
            }
            pt[nt][2 * r + c] = pk;
            dpt[nt][2 * r + c] = ds;
          }
        }
      M::template mix<ATL_CH>(dv, pt, gsl + c0 * LD, lane);
      M::template mix<ATL_CH>(dk, dpt, qsl + c0 * LD, lane);
    }
    __syncthreads();
  }
  atl_stage<T, D>(kw, dk, lane);
  atl_stage<T, D>(vw, dv, lane);
  __syncwarp();
  const size_t kv_off = (size_t)b * a.s_k * a.dkv_ld + col;
  atl_store<T, LD>(a.dk + kv_off, a.dkv_ld, kw, j0 + warp * 16, a.s_k, a.hd, vec, lane);
  atl_store<T, LD>(a.dv + kv_off, a.dkv_ld, vw, j0 + warp * 16, a.s_k, a.hd, vec, lane);
}

// ---------------------------------------------------- head_dim past 128
// A head wider than ATW_D (128) columns is cut into 128-column chunks: a
// 64 x 64 tile of q k^T (and of g v^T) is summed chunk by chunk in the
// accumulator registers, each chunk of both operands staged through shared
// memory, and p (ds, p kappa) is then mixed with one chunk of v (of k; of q
// or g) at a time. Two grids:
// - up to 64 keys (forward, dq) or 64 queries (dk / dv) one tile holds the
//   whole sweep (ATW_ONE): a block takes every output chunk of its tile,
//   its scores computed once and kept in registers, the next chunk of the
//   mixed operand loading behind this chunk's products;
// - past that a block takes one output chunk (of ctx; of dq; of dk or of
//   dv) and recomputes the scores: the two sweeps of the long kernels
//   above, over whole 64-key tiles.
// The function and its rounding points are the long kernels' (attention_long.cuh).

constexpr int ATW_D = 128;
constexpr int ATW_ONE = 4;  // the kernels' flag: one tile holds the sweep

__host__ __device__ constexpr int atw_chunks(int hd) { return (hd + ATW_D - 1) / ATW_D; }

template <typename T>
constexpr int atw_bytes() {  // three 64 x 128 tiles and the key mask
  return 3 * atl_tile_bytes<T, ATW_D>() + ATL_MASK_BYTES;
}

// rows row0 .. row0 + 63, columns [c0, c0 + 128) of src (hd columns at row
// stride ld) into a tile at row stride LD: zero past `rows` and past hd
template <typename T, int LD>
__device__ __forceinline__ void atw_tile(T* dst, const T* src, int ld, int row0, int rows, int c0,
                                         int hd, bool vec) {
  const int wc = min(ATW_D, hd - c0);
  if (vec) {
    constexpr int E = 16 / static_cast<int>(sizeof(T)), CPR = ATW_D / E;
    for (int c = threadIdx.x; c < ATL_TILE * CPR; c += ATL_THREADS) {
      const int r = c / CPR, col = (c - r * CPR) * E, row = row0 + r;
      const bool in = row < rows && col < wc;
      cp_async16(dst + r * LD + col, in ? src + (size_t)row * ld + c0 + col : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < ATL_TILE * ATW_D; e += ATL_THREADS) {
      const int r = e / ATW_D, col = e - r * ATW_D, row = row0 + r;
      dst[r * LD + col] =
          row < rows && col < wc ? src[(size_t)row * ld + c0 + col] : static_cast<T>(0.0f);
    }
  }
}

// fn(NT) for the n8 tiles that hold `rows` real rows of a 64-row tile (2,
// 4, 6 or 8: whole 16-row pairs): the products skip the tile's zero rows
template <typename Fn>
__device__ __forceinline__ void atw_by_rows(int rows, Fn&& fn) {
  switch ((min(rows, ATL_TILE) + 15) / 16) {
    case 1: fn(std::integral_constant<int, 2>()); break;
    case 2: fn(std::integral_constant<int, 4>()); break;
    case 3: fn(std::integral_constant<int, 6>()); break;
    default: fn(std::integral_constant<int, 8>()); break;
  }
}

// acc += the warp's 16 rows of A (rows a0.. of a) times rows b0 .. b0 + 63
// of b, transposed, over all hd columns: chunk by chunk through the tiles
// as and bs; a warp whose rows are all past a_rows, and the n8 tiles of b's
// rows past b_rows, skip their products (their scores stay 0). Ends with a
// barrier; waits for every cp.async group in flight.
template <typename T>
__device__ __forceinline__ void atw_scores(float (&acc)[ATL_TILE / 8][4], T* as, T* bs,
                                           const T* a, int a_ld, int a0, int a_rows, const T* b,
                                           int b_ld, int b0, int b_rows, int hd, bool vec,
                                           int warp, int lane) {
  using M = Atl<T, ATW_D>;
  const bool active = a0 + warp * 16 < a_rows;
  for (int c0 = 0; c0 < hd; c0 += ATW_D) {
    atw_tile<T, M::LD>(as, a, a_ld, a0, a_rows, c0, hd, vec);
    atw_tile<T, M::LD>(bs, b, b_ld, b0, b_rows, c0, hd, vec);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (active)
      atw_by_rows(b_rows - b0, [&](auto nt) {
        constexpr int NT = decltype(nt)::value;
        M::template abt<NT>(reinterpret_cast<float (&)[NT][4]>(acc), as + warp * 16 * M::LD, bs,
                            lane);
      });
    __syncthreads();
  }
}

// o += p X over X's first `rows` rows (the rest of p is 0)
template <typename T>
__device__ __forceinline__ void atw_mix(float (&o)[ATW_D / 8][4],
                                        const float (&p)[ATL_TILE / 8][4], const T* X, int rows,
                                        int lane) {
  atw_by_rows(rows, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    Atl<T, ATW_D>::template mix<NT>(o, reinterpret_cast<const float (&)[NT][4]>(p), X, lane);
  });
}

// A warp's 16 rows of one output chunk (the accumulators o) out through its
// own 16 rows of `rows` (row stride LD) to rows row0.. of dst (row stride
// ld), its wc columns, those below `n_rows`
template <typename T>
__device__ __forceinline__ void atw_put(T* dst, int ld, T* rows,
                                        const float (&o)[ATW_D / 8][4], int row0, int n_rows,
                                        int wc, bool vec, int lane) {
  atl_stage<T, ATW_D>(rows, o, lane);
  __syncwarp();
  atl_store<T, Atl<T, ATW_D>::LD>(dst, ld, rows, row0, n_rows, wc, vec, lane);
  __syncwarp();
}

// The mix of every output chunk in [oc0, oc1) with p (the A operand, in
// registers): chunk oc of src (its rows x0.. of x_rows) staged in turns in
// the tiles b0 (holding chunk oc0 already, or loading it) and b1, the next
// loading behind this one's products; each chunk's 16 rows a warp out
// through its own rows of `rows` to dst's chunk oc.
template <typename T>
__device__ __forceinline__ void atw_mix_chunks(const float (&p)[ATL_TILE / 8][4], T* b0, T* b1,
                                               T* rows, const T* src, int src_ld, int x0,
                                               int x_rows, T* dst, int dst_ld, int row0,
                                               int n_rows, int oc0, int oc1, int hd, bool vec,
                                               int lane) {
  using M = Atl<T, ATW_D>;
  for (int oc = oc0; oc < oc1; ++oc) {
    T* buf = (oc - oc0) & 1 ? b1 : b0;
    if (oc + 1 < oc1)
      atw_tile<T, M::LD>((oc - oc0) & 1 ? b0 : b1, src, src_ld, x0, x_rows, (oc + 1) * ATW_D, hd,
                         vec);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (row0 < n_rows) {  // the warp has a real row
      float o[ATW_D / 8][4] = {};
      atw_mix(o, p, buf, x_rows - x0, lane);
      atw_put(dst + oc * ATW_D, dst_ld, rows, o, row0, n_rows, min(ATW_D, hd - oc * ATW_D), vec,
              lane);
    }
    __syncthreads();  // buf is free for chunk oc + 2
  }
}

// Forward: block (sentence, head, query tile[, output chunk]).
template <typename T>
__global__ void __launch_bounds__(ATL_THREADS) attention_wide_kernel(AttnArgs<T> a, int flags) {
  using M = Atl<T, ATW_D>;
  constexpr int LD = M::LD, TILE = ATL_TILE * LD, NT = ATL_TILE / 8;
  extern __shared__ __align__(16) unsigned char atl_smem[];
  const bool vec = flags & ATL_VEC, wm = flags & ATL_WHERE_MASK, one = flags & ATW_ONE;
  const int nc = atw_chunks(a.hd), nqt = atl_tiles(a.s_q), gc = one ? 1 : nc;
  T* qs = reinterpret_cast<T*>(atl_smem);
  T* ks = qs + TILE;
  T* vs = ks + TILE;
  int* msk = reinterpret_cast<int*>(vs + TILE);
  const int oc0 = blockIdx.x % gc, rest = blockIdx.x / gc, oc1 = one ? nc : oc0 + 1;
  const int bh = rest / nqt, i0 = (rest - bh * nqt) * ATL_TILE;
  const int b = bh / a.nh, h = bh - b * a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const size_t col = (size_t)h * a.hd;
  const T* qb = a.q + (size_t)b * a.s_q * a.q_ld + col;
  const T* kb = a.k + (size_t)b * a.s_k * a.kv_ld + col;
  const T* vb = a.v + (size_t)b * a.s_k * a.kv_ld + col;
  T* ob = a.out + (size_t)b * a.s_q * a.out_ld + col;
  const int n = atl_key_tiles(a, i0, atl_mask(msk, a, b));
  const int iw = i0 + warp * 16 + g8;  // the warp's rows iw and iw + 8
  T* qw = qs + warp * 16 * LD;         // its q rows, then its output rows
  const uint32_t op = a.op_base + h;
  if (n == 1) {
    // one key tile: its scores once, in registers, then every output chunk
    atw_tile<T, LD>(vs, vb, a.kv_ld, 0, a.s_k, oc0 * ATW_D, a.hd, vec);
    cp_commit();
    float sc[NT][4] = {};
    atw_scores(sc, qs, ks, qb, a.q_ld, i0, a.s_q, kb, a.kv_ld, 0, a.s_k, a.hd, vec, warp, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) atl_probs(sc, r, iw + 8 * r, a, msk, wm, b, op, t4);
    atw_mix_chunks(sc, vs, ks, qw, vb, a.kv_ld, 0, a.s_k, ob, a.out_ld, i0 + warp * 16, a.s_q, oc0,
                   oc1, a.hd, vec, lane);
    return;
  }
  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.0f, 0.0f};
  float o[ATW_D / 8][4] = {};
  // step s < n: key tile s for the max and sum; s >= n: key tile s - n for p V
  for (int s = 0; s < 2 * n; ++s) {
    const int j0 = (s % n) * ATL_TILE;
    if (s >= n) {  // v's chunk oc0 of the tile, loading with the first chunk of the scores
      atw_tile<T, LD>(vs, vb, a.kv_ld, j0, a.s_k, oc0 * ATW_D, a.hd, vec);
      cp_commit();
    }
    float sc[NT][4] = {};
    atw_scores(sc, qs, ks, qb, a.q_ld, i0, a.s_q, kb, a.kv_ld, j0, a.s_k, a.hd, vec, warp, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + 8 * r;
      if (s < n) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = j0 + nt * 8 + 2 * t4 + c;
            float x = -INFINITY;
            if (j < a.s_k) {
              x = atl_x(sc[nt][2 * r + c], msk[j] > 0 && !(a.causal && j > i), a.scale, wm);
              mx = fmaxf(mx, x);
            }
            sc[nt][2 * r + c] = x;
          }
        const float mn = fmaxf(m[r], quad_max(mx));  // finite: the tile has a real key
        float e = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) e += expf(sc[nt][2 * r + c] - mn);  // 0 past s_k
        z[r] = z[r] * expf(m[r] - mn) + quad_sum(e);
        m[r] = mn;
      } else {
        const float inv_z = rcp_rn(z[r]);
        const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = j0 + nt * 8 + 2 * t4 + c;
            float p = 0.0f;
            if (j < a.s_k) {
              const bool ok = msk[j] > 0 && !(a.causal && j > i);
              const float e = expf(atl_x(sc[nt][2 * r + c], ok, a.scale, wm) - m[r]);
              if (wm) {
                p = e * inv_z;
              } else {
                p = div_rn(e, z[r], inv_z);
                if (a.drop.on) p *= dropout_keep(rt, j, a.drop);
              }
            }
            sc[nt][2 * r + c] = p;
          }
      }
    }
    if (s >= n && i0 + warp * 16 < a.s_q) atw_mix(o, sc, vs, a.s_k - j0, lane);
    __syncthreads();  // vs is free for the next tile's v
  }
  atw_put(ob + oc0 * ATW_D, a.out_ld, qw, o, i0 + warp * 16, a.s_q,
          min(ATW_D, a.hd - oc0 * ATW_D), vec, lane);
}

// Backward, dq: block (sentence, head, query tile[, dq chunk]). The blocks
// of chunk 0 write each query row's (max, sum of exp z, 1 / z, t) to
// a.stats for attention_wide_dkv_kernel.
template <typename T>
__global__ void __launch_bounds__(ATL_THREADS) attention_wide_dq_kernel(AttnArgs<T> a,
                                                                          int flags) {
  using M = Atl<T, ATW_D>;
  constexpr int LD = M::LD, TILE = ATL_TILE * LD, NT = ATL_TILE / 8;
  extern __shared__ __align__(16) unsigned char atl_smem[];
  const bool vec = flags & ATL_VEC, one = flags & ATW_ONE;
  const int nc = atw_chunks(a.hd), nqt = atl_tiles(a.s_q), gc = one ? 1 : nc;
  T* as = reinterpret_cast<T*>(atl_smem);
  T* bs = as + TILE;
  T* xs = bs + TILE;
  int* msk = reinterpret_cast<int*>(xs + TILE);
  const int oc0 = blockIdx.x % gc, rest = blockIdx.x / gc, oc1 = one ? nc : oc0 + 1;
  const int bh = rest / nqt, i0 = (rest - bh * nqt) * ATL_TILE;
  const int b = bh / a.nh, h = bh - b * a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const size_t col = (size_t)h * a.hd;
  const T* qb = a.q + (size_t)b * a.s_q * a.q_ld + col;
  const T* kb = a.k + (size_t)b * a.s_k * a.kv_ld + col;
  const T* vb = a.v + (size_t)b * a.s_k * a.kv_ld + col;
  const int H = a.nh * a.hd;
  const T* gb = a.g + (size_t)b * a.s_q * H + col;
  T* dqb = a.out + (size_t)b * a.s_q * a.out_ld + col;
  const int n = atl_key_tiles(a, i0, atl_mask(msk, a, b));
  const int iw = i0 + warp * 16 + g8;
  T* aw = as + warp * 16 * LD;  // the warp's rows of the A tile, then its output rows
  const uint32_t op = a.op_base + h;
  auto keep_stats = [&](int i, float m, float z, float rz, float t) {
    if (oc0 == 0 && t4 == 0 && i < a.s_q)
      *reinterpret_cast<float4*>(a.stats + ((size_t)bh * a.s_q + i) * 4) = make_float4(m, z, rz, t);
  };
  if (n == 1) {
    // one key tile: s and dp once, in registers; ds = p (dp kappa - t) *
    // scale, rounded at the mix; then ds K, chunk by chunk
    atw_tile<T, LD>(xs, kb, a.kv_ld, 0, a.s_k, oc0 * ATW_D, a.hd, vec);
    cp_commit();
    float sc[NT][4] = {}, dp[NT][4] = {};
    atw_scores(sc, as, bs, qb, a.q_ld, i0, a.s_q, kb, a.kv_ld, 0, a.s_k, a.hd, vec, warp, lane);
    atw_scores(dp, as, bs, gb, H, i0, a.s_q, vb, a.kv_ld, 0, a.s_k, a.hd, vec, warp, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + 8 * r;
      const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = nt * 8 + 2 * t4 + c;
          float x = -INFINITY;
          if (j < a.s_k) {
            x = atl_x(sc[nt][2 * r + c], msk[j] > 0 && !(a.causal && j > i), a.scale, false);
            mx = fmaxf(mx, x);
          }
          sc[nt][2 * r + c] = x;
        }
      mx = quad_max(mx);
      float se = 0.0f, sd = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = nt * 8 + 2 * t4 + c;
          float e = 0.0f, d = 0.0f;
          if (j < a.s_k) {
            e = expf(sc[nt][2 * r + c] - mx);
            d = dp[nt][2 * r + c];
            if (a.drop.on) d *= dropout_keep(rt, j, a.drop);
          }
          se += e;
          sd += e * d;
          sc[nt][2 * r + c] = e;
          dp[nt][2 * r + c] = d;
        }
      const float z = quad_sum(se), rz = rcp_rn(z), t = div_rn(quad_sum(sd), z, rz);
      keep_stats(i, mx, z, rz, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = nt * 8 + 2 * t4 + c;
          const float p = div_rn(sc[nt][2 * r + c], z, rz);
          sc[nt][2 * r + c] =
              i < a.s_q && j < a.s_k ? p * (dp[nt][2 * r + c] - t) * a.scale : 0.0f;
        }
    }
    atw_mix_chunks(sc, xs, bs, aw, kb, a.kv_ld, 0, a.s_k, dqb, a.out_ld, i0 + warp * 16, a.s_q,
                   oc0, oc1, a.hd, vec, lane);
    return;
  }
  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.0f, 0.0f}, tau[2] = {0.0f, 0.0f};
  float t[2] = {0.0f, 0.0f}, rz[2] = {0.0f, 0.0f};
  float dq[ATW_D / 8][4] = {};
  for (int s = 0; s < 2 * n; ++s) {
    const int j0 = (s % n) * ATL_TILE;
    if (s >= n) {  // k's chunk oc0 of the tile, for ds K
      atw_tile<T, LD>(xs, kb, a.kv_ld, j0, a.s_k, oc0 * ATW_D, a.hd, vec);
      cp_commit();
    }
    float sc[NT][4] = {}, dp[NT][4] = {};
    atw_scores(sc, as, bs, qb, a.q_ld, i0, a.s_q, kb, a.kv_ld, j0, a.s_k, a.hd, vec, warp, lane);
    atw_scores(dp, as, bs, gb, H, i0, a.s_q, vb, a.kv_ld, j0, a.s_k, a.hd, vec, warp, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + 8 * r;
      const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
      if (s < n) {
        // max, sum of exp and the sum of e * dp * kappa, online
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = j0 + nt * 8 + 2 * t4 + c;
            float x = -INFINITY;
            if (j < a.s_k) {
              x = atl_x(sc[nt][2 * r + c], msk[j] > 0 && !(a.causal && j > i), a.scale, false);
              mx = fmaxf(mx, x);
            }
            sc[nt][2 * r + c] = x;
          }
        const float mn = fmaxf(m[r], quad_max(mx));
        float se = 0.0f, sd = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = j0 + nt * 8 + 2 * t4 + c;
            if (j < a.s_k) {
              const float e = expf(sc[nt][2 * r + c] - mn);
              float d = dp[nt][2 * r + c];
              if (a.drop.on) d *= dropout_keep(rt, j, a.drop);
              se += e;
              sd += e * d;
            }
          }
        const float al = expf(m[r] - mn);
        z[r] = z[r] * al + quad_sum(se);
        tau[r] = tau[r] * al + quad_sum(sd);
        m[r] = mn;
        if (s == n - 1) {
          rz[r] = rcp_rn(z[r]);
          t[r] = div_rn(tau[r], z[r], rz[r]);
          keep_stats(i, m[r], z[r], rz[r], t[r]);
        }
      } else {
        // ds = p (dp kappa - t) * scale, rounded at the mix
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = j0 + nt * 8 + 2 * t4 + c;
            float ds = 0.0f;
            if (i < a.s_q && j < a.s_k) {
              const bool ok = msk[j] > 0 && !(a.causal && j > i);
              const float p =
                  div_rn(expf(atl_x(sc[nt][2 * r + c], ok, a.scale, false) - m[r]), z[r], rz[r]);
              float d = dp[nt][2 * r + c];
              if (a.drop.on) d *= dropout_keep(rt, j, a.drop);
              ds = p * (d - t[r]) * a.scale;
            }
            sc[nt][2 * r + c] = ds;
          }
      }
    }
    if (s >= n && i0 + warp * 16 < a.s_q) atw_mix(dq, sc, xs, a.s_k - j0, lane);
    __syncthreads();  // xs is free for the next tile's k
  }
  atw_put(dqb + oc0 * ATW_D, a.out_ld, aw, dq, i0 + warp * 16, a.s_q,
          min(ATW_D, a.hd - oc0 * ATW_D), vec, lane);
}

// Backward, dk and dv: block (sentence, head, key tile, x), from the query
// rows' statistics that attention_wide_dq_kernel wrote, the scores as K Q^T
// (key rows). With ATW_ONE (one query tile) x < 2: every chunk of dv (x 0)
// or of dk (x 1); else x < 2 nc: chunk x of dv, or x - nc of dk.
template <typename T>
__global__ void __launch_bounds__(ATL_THREADS) attention_wide_dkv_kernel(AttnArgs<T> a,
                                                                           int flags) {
  using M = Atl<T, ATW_D>;
  constexpr int LD = M::LD, TILE = ATL_TILE * LD, NT = ATL_TILE / 8;
  extern __shared__ __align__(16) unsigned char atl_smem[];
  const bool vec = flags & ATL_VEC, one = flags & ATW_ONE;
  const int nc = atw_chunks(a.hd), nqt = atl_tiles(a.s_q), nkt = atl_tiles(a.s_k);
  const int gc = one ? 2 : 2 * nc;
  T* as = reinterpret_cast<T*>(atl_smem);
  T* bs = as + TILE;
  T* xs = bs + TILE;
  int* msk = reinterpret_cast<int*>(xs + TILE);
  const int x2 = blockIdx.x % gc, rest = blockIdx.x / gc;
  const bool want_dk = one ? x2 == 1 : x2 >= nc;
  const int oc = one ? 0 : want_dk ? x2 - nc : x2, oc1 = one ? nc : oc + 1;
  const int bh = rest / nkt, j0 = (rest - bh * nkt) * ATL_TILE;
  const int b = bh / a.nh, h = bh - b * a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const size_t col = (size_t)h * a.hd;
  const int H = a.nh * a.hd;
  const T* qb = a.q + (size_t)b * a.s_q * a.q_ld + col;
  const T* gb = a.g + (size_t)b * a.s_q * H + col;
  const T* kb = a.k + (size_t)b * a.s_k * a.kv_ld + col;
  const T* vb = a.v + (size_t)b * a.s_k * a.kv_ld + col;
  const size_t kv_off = (size_t)b * a.s_k * a.dkv_ld + col;
  const float* stb = a.stats + (size_t)bh * a.s_q * 4;
  const int first = atl_mask(msk, a, b);
  // under the causal mask the query tiles [lo, lo + skip) give this key tile
  // nothing (attention_long_dkv_kernel)
  int lo = nqt, skip = 0;
  if (a.causal && first < a.s_k) {
    lo = (first + ATL_TILE - 1) / ATL_TILE;
    skip = max(0, min(nqt, j0 / ATL_TILE) - lo);
  }
  const int jw = j0 + warp * 16 + g8;  // the warp's keys jw and jw + 8
  T* aw = as + warp * 16 * LD;         // its rows of the A tile, then its output rows
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) valid[r] = jw + 8 * r < a.s_k && msk[jw + 8 * r] > 0;
  const uint32_t op = a.op_base + h;
  float acc[ATW_D / 8][4] = {};
  for (int s = 0; s < nqt - skip; ++s) {
    const int i0 = (s < lo ? s : s + skip) * ATL_TILE;
    // the first mixed chunk: g's chunk oc for dv, q's for dk
    atw_tile<T, LD>(xs, want_dk ? qb : gb, want_dk ? a.q_ld : H, i0, a.s_q, oc * ATW_D, a.hd,
                    vec);
    cp_commit();
    float pt[NT][4] = {}, dpt[NT][4] = {};
    atw_scores(pt, as, bs, kb, a.kv_ld, j0, a.s_k, qb, a.q_ld, i0, a.s_q, a.hd, vec, warp, lane);
    if (want_dk)
      atw_scores(dpt, as, bs, vb, a.kv_ld, j0, a.s_k, gb, H, i0, a.s_q, a.hd, vec, warp, lane);
    // pt <- p kappa (dv's A operand), dpt <- ds (dk's)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + nt * 8 + 2 * t4 + c;
        if (i >= a.s_q) {
          pt[nt][c] = pt[nt][2 + c] = dpt[nt][c] = dpt[nt][2 + c] = 0.0f;
          continue;
        }
        const float4 sr = *reinterpret_cast<const float4*>(stb + (size_t)i * 4);  // m, z, 1/z, t
        const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = jw + 8 * r;
          float pk = 0.0f, ds = 0.0f;
          if (j < a.s_k) {
            const bool ok = valid[r] && !(a.causal && j > i);
            const float p =
                div_rn(expf(atl_x(pt[nt][2 * r + c], ok, a.scale, false) - sr.x), sr.y, sr.z);
            float d = dpt[nt][2 * r + c], kap = 1.0f;
            if (a.drop.on) {
              kap = dropout_keep(rt, j, a.drop);
              d *= kap;
            }
            pk = a.drop.on ? p * kap : p;
            ds = p * (d - sr.w) * a.scale;
          }
          pt[nt][2 * r + c] = pk;
          dpt[nt][2 * r + c] = ds;
        }
      }
    if (one) {  // the only query tile: every chunk of dk, or of dv
      if (want_dk)
        atw_mix_chunks(dpt, xs, bs, aw, qb, a.q_ld, i0, a.s_q, a.dk + kv_off, a.dkv_ld,
                       j0 + warp * 16, a.s_k, 0, nc, a.hd, vec, lane);
      else
        atw_mix_chunks(pt, xs, bs, aw, gb, H, i0, a.s_q, a.dv + kv_off, a.dkv_ld, j0 + warp * 16,
                       a.s_k, 0, nc, a.hd, vec, lane);
      return;
    }
    if (j0 + warp * 16 < a.s_k) {
      if (want_dk)
        atw_mix(acc, dpt, xs, a.s_q - i0, lane);
      else
        atw_mix(acc, pt, xs, a.s_q - i0, lane);
    }
    __syncthreads();  // xs is free for the next tile
  }
  // (with ATW_ONE here only when no query tile reaches this key tile: zeros)
  for (int c = oc; c < oc1; ++c)
    atw_put((want_dk ? a.dk : a.dv) + kv_off + c * ATW_D, a.dkv_ld, aw, acc, j0 + warp * 16,
            a.s_k, min(ATW_D, a.hd - c * ATW_D), vec, lane);
}

// Launches KERNEL on grid blocks with `bytes` of shared memory, raising the
// kernel's limit once per device.
template <typename T, void (*KERNEL)(AttnArgs<T>, int)>
int atl_launch(const AttnArgs<T>& a, int flags, int grid, int bytes, cudaStream_t st) {
  static unsigned configured = 0;  // a bit per device whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 32 || !(configured >> dev & 1u)) {
    e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, ATT_SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 32) configured |= 1u << dev;
  }
  KERNEL<<<grid, ATL_THREADS, bytes, st>>>(a, flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int atl_fwd_run(const AttnArgs<T>& a, int flags, cudaStream_t st) {
  const int slots = std::min(atl_tiles(a.s_k), 2);
  return atl_launch<T, attention_long_kernel<T, D>>(
      a, flags, a.batch * a.nh * atl_tiles(a.s_q),
      (1 + 2 * slots) * atl_tile_bytes<T, D>() + ATL_MASK_BYTES, st);
}

template <typename T, int D>
int atl_bwd_run(const AttnArgs<T>& a, int flags, cudaStream_t st) {
  const int nqt = atl_tiles(a.s_q), nkt = atl_tiles(a.s_k), tb = atl_tile_bytes<T, D>();
  const int kslots = std::min(nkt, 2), qslots = std::min(nqt, 2);
  const int e = atl_launch<T, attention_long_dq_kernel<T, D>>(
      a, flags, a.batch * a.nh * nqt, (2 + 2 * kslots) * tb + ATL_MASK_BYTES, st);
  if (e != 0) return e;
  return atl_launch<T, attention_long_dkv_kernel<T, D>>(
      a, flags, a.batch * a.nh * nkt,
      (2 + 2 * qslots) * tb + qslots * ATL_TILE * 4 * 4 + ATL_MASK_BYTES, st);
}

// head_dim past 128: up to 64 keys (queries for dk / dv) a block a tile
// (ATW_ONE), else a block a tile and output chunk
template <typename T>
int atw_fwd_run(const AttnArgs<T>& a, int flags, cudaStream_t st) {
  const bool one = a.s_k <= ATL_TILE;
  const int grid = a.batch * a.nh * atl_tiles(a.s_q) * (one ? 1 : atw_chunks(a.hd));
  return atl_launch<T, attention_wide_kernel<T>>(a, flags | (one ? ATW_ONE : 0), grid,
                                                 atw_bytes<T>(), st);
}

template <typename T>
int atw_bwd_run(const AttnArgs<T>& a, int flags, cudaStream_t st) {
  const int nc = atw_chunks(a.hd);
  const bool one_k = a.s_k <= ATL_TILE, one_q = a.s_q <= ATL_TILE;
  const int e = atl_launch<T, attention_wide_dq_kernel<T>>(
      a, flags | (one_k ? ATW_ONE : 0), a.batch * a.nh * atl_tiles(a.s_q) * (one_k ? 1 : nc),
      atw_bytes<T>(), st);
  if (e != 0) return e;
  return atl_launch<T, attention_wide_dkv_kernel<T>>(
      a, flags | (one_q ? ATW_ONE : 0), a.batch * a.nh * atl_tiles(a.s_k) * (one_q ? 2 : 2 * nc),
      atw_bytes<T>(), st);
}

template <typename T>
int atl_fwd(const AttnArgs<T>& a, bool where_mask, cudaStream_t st) {
  if (!attention_fits(a.s_q, a.s_k, a.hd)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch * a.nh <= 0) return 0;
  const int flags = (att_vec(a, false) ? ATL_VEC : 0) | (where_mask ? ATL_WHERE_MASK : 0);
  if (a.hd > ATW_D) return atw_fwd_run(a, flags, st);
  return a.hd <= 64 ? atl_fwd_run<T, 64>(a, flags, st) : atl_fwd_run<T, 128>(a, flags, st);
}

template <typename T>
int atl_bwd(const AttnArgs<T>& a, cudaStream_t st) {
  if (!attention_fits(a.s_q, a.s_k, a.hd) || a.stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch * a.nh <= 0) return 0;
  const int flags = att_vec(a, true) ? ATL_VEC : 0;
  if (a.hd > ATW_D) return atw_bwd_run(a, flags, st);
  return a.hd <= 64 ? atl_bwd_run<T, 64>(a, flags, st) : atl_bwd_run<T, 128>(a, flags, st);
}

}  // namespace

namespace kvq {

int attention_long_fwd(const AttnArgs<bf16>& a, bool where_mask, cudaStream_t st) {
  return atl_fwd(a, where_mask, st);
}
int attention_long_fwd(const AttnArgs<float>& a, bool where_mask, cudaStream_t st) {
  return atl_fwd(a, where_mask, st);
}
int attention_long_bwd(const AttnArgs<bf16>& a, cudaStream_t st) { return atl_bwd(a, st); }
int attention_long_bwd(const AttnArgs<float>& a, cudaStream_t st) { return atl_bwd(a, st); }

}  // namespace kvq
