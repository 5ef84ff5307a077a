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
// - head_dim past 128 at every length (below): 64-column chunks in a
//   cp.async ring, the scores summed over the chunks and computed
//   once for every output chunk a warp or block holds; up to 32 queries and
//   keys a warp a (sentence, head) (attention_wide_short_kernel, _bwd_kernel),
//   past that 64-row tiles (attention_wide_kernel, _dq_kernel, _dkv_kernel).
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
// A head wider than ATT_MAX_HD (128) columns is cut into AW_C (64)-column
// chunks that stream through shared memory in a cp.async ring (two slots a
// warp in the short kernels, AW_STAGES a block in the long ones): each step
// issues the loads of a step ahead, then waits for its own. The score
// products (Q K^T, G V^T) accumulate over every chunk in f32 accumulator
// registers (Atl<T, 64>: bf16 m16n8k16 16 deep, f32 3xTF32 m16n8k8 8 deep),
// and every output goes out a chunk at a time, so no register array grows
// with head_dim. Two designs, by length:
// - up to 32 queries and keys (dSentences' 12-14 tokens, the serving
//   buckets): attention_wide_short_kernel / _bwd_kernel, a warp a
//   (sentence, head) as in attention.cuh: m16 row blocks padded to 16 or
//   32, a persistent grid from the occupancy of the warp's shared memory
//   (att_launch: the ring's two slots, the backward's P kappa / dS copies
//   and staging tile, the key mask), the next unit's first loads behind this
//   unit's last chunk, 16-byte stores through the staging rows. The
//   backward computes S and dP once for dq, dk and dv (attention_bwd_kernel's
//   arithmetic), so it needs no statistics scratch; its output steps read
//   q, k and g a second time, chunk by chunk;
// - past that: attention_wide_kernel / _dq_kernel / _dkv_kernel, a block of
//   4 warps a 64-row tile of queries (of keys for dk / dv) and a group of
//   output chunks (AW_G_*), with the two sweeps of the long kernels above
//   (the rows' max and sum, then p): each sweep computes a key (query)
//   tile's scores once over every chunk and mixes them into every output
//   chunk the block holds, in accumulator registers; the dk / dv block
//   computes P and dS once for both. Up to 64 keys (queries) a block holds
//   every output chunk (ATW_ONE): the scores are final after one tile and
//   each chunk goes out as it is mixed.
// The function and its rounding points are the long kernels'
// (attention_long.cuh). What bounds it: the bytes, as above; the design
// keeps each warp's or block's next loads in flight behind its products and
// computes each score tile once for every output chunk it feeds.

constexpr int AW_C = 64;    // columns of a head_dim chunk
constexpr int ATW_ONE = 4;  // the kernels' flag: one tile holds the sweep, a block every chunk
// output chunks a long block accumulates over its sweep: ctx, dq, dk with
// dv. On an H100 at 512 tokens x head_dim 192 the forward's 4 spilled and
// ran 9% slower than 3; the backward's 2 / 1 ran 44% slower than 3 / 2,
// whose spills cost less than computing the scores again in each group.
constexpr int AW_G_FWD = 3, AW_G_DQ = 3, AW_G_DKV = 2;
// the long blocks' ring slots: on an H100 a third measured no faster than
// two, and a fourth up to 66% slower in f32 (fewer blocks an SM)
constexpr int AW_STAGES = 2;

__host__ __device__ constexpr int aw_chunks(int hd) { return (hd + AW_C - 1) / AW_C; }

template <typename T>
using Aw = Atl<T, AW_C>;

// rows row0 .. row0 + n - 1 of src (row stride ld; those at or past `rows`
// zero), columns [c0, c0 + AW_C) (zero at or past hd) into dst at row
// stride Aw<T>::LD; thread tid of nt
template <typename T>
__device__ __forceinline__ void aw_load(T* dst, const T* src, int ld, int row0, int n, int rows,
                                        int c0, int hd, bool vec, int tid, int nt) {
  constexpr int LD = Aw<T>::LD;
  const int wc = min(AW_C, hd - c0);
  if (vec) {
    constexpr int E = 16 / static_cast<int>(sizeof(T)), CPR = AW_C / E;
    for (int c = tid; c < n * CPR; c += nt) {
      const int r = c / CPR, col = (c - r * CPR) * E, row = row0 + r;
      const bool in = row < rows && col < wc;
      cp_async16(dst + r * LD + col, in ? src + (size_t)row * ld + c0 + col : src, in);
    }
  } else {
    for (int e = tid; e < n * AW_C; e += nt) {
      const int r = e / AW_C, col = e - r * AW_C, row = row0 + r;
      dst[r * LD + col] =
          row < rows && col < wc ? src[(size_t)row * ld + c0 + col] : static_cast<T>(0.0f);
    }
  }
}

// ------------------------------------------- up to 32 queries and keys

// One warp's shared memory in the short wide kernels, in elements of T: two
// ring slots (the forward: a q tile, then a k or v tile; the backward: q,
// k, g, v), the backward's P kappa and dS copies and staging tile, then the
// key mask (ATT_MAX_S ints)
struct AwsPlan {
  int sqp, skp;   // rows padded to 16 or 32
  int tq, tk;     // elements of a q (or g) and of a k (or v) chunk tile
  int slot, tld;  // elements of a ring slot; row stride of the copies (skp + 16 bytes)
  int bytes;      // a warp's bytes, a multiple of 16
};

template <typename T>
__host__ __device__ inline AwsPlan aws_plan(int s_q, int s_k, bool bwd) {
  constexpr int LD = Aw<T>::LD, PAD = 16 / static_cast<int>(sizeof(T));
  AwsPlan p;
  p.sqp = s_q > 16 ? 32 : 16;
  p.skp = s_k > 16 ? 32 : 16;
  p.tq = p.sqp * LD;
  p.tk = p.skp * LD;
  p.slot = bwd ? 2 * (p.tq + p.tk) : p.tq + p.tk;
  p.tld = p.skp + PAD;
  const int extra = bwd ? 2 * p.sqp * p.tld + (p.sqp > p.skp ? p.tq : p.tk) : 0;
  p.bytes = (2 * p.slot + extra) * static_cast<int>(sizeof(T)) + ATT_MAX_S * 4;
  return p;
}

// Zero the warp's shared memory and, for a call without a key mask, mark
// every key valid. Loads write only the sentence's rows, so the padding
// stays finite: zero, or in the forward's q tile the staged outputs of its
// padded rows (scores of padded query rows, which no output keeps).
__device__ __forceinline__ void aws_init(unsigned char* mine, int bytes, int* msk, bool no_mask,
                                         int lane) {
  att_zero(mine, bytes, lane);
  __syncwarp();
  if (no_mask) msk[lane] = 1;  // ATT_MAX_S == 32
  __syncwarp();
}

// rows [0, n) x wc columns of the staging rows st (row stride LD) out to
// dst (row stride ld), 16 rows at a time
template <typename T>
__device__ __forceinline__ void aws_store(T* dst, int ld, const T* st, int n, int wc, bool vec,
                                          int lane) {
  for (int m0 = 0; m0 < n; m0 += 16)
    atl_store<T, Aw<T>::LD>(dst, ld, st + m0 * Aw<T>::LD, m0, n, wc, vec, lane);
}

// o += the transpose of the (query, key) copy C (row stride tld; its first
// 16 KB query rows, the 16 key columns from m0) times X's (query, AW_C)
// chunk tile: dk = dS^T Q and dv = (P kappa)^T G, A through ldmatrix.trans
template <int KB>
__device__ __forceinline__ void aws_mix_t(float (&o)[AW_C / 8][4], const bf16* C, int tld, int m0,
                                          const bf16* X, int lane) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    uint32_t at[4];
    att_a_trans(at, C, tld, kb * 16, m0, lane);
#pragma unroll
    for (int d0 = 0; d0 < AW_C; d0 += 16) {
      uint32_t bx[4];
      att_b_trans(bx, X, Aw<bf16>::LD, kb * 16, d0, lane);
      mma_bf16(o[d0 / 8], at, bx[0], bx[1]);
      mma_bf16(o[d0 / 8 + 1], at, bx[2], bx[3]);
    }
  }
}

// the same in f32: 3xTF32 k8 steps, A and B in attf_b_pairs' slot order
template <int KB>
__device__ __forceinline__ void aws_mix_t(float (&o)[AW_C / 8][4], const float* C, int tld,
                                          int m0, const float* X, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2 * KB; ++ks) {
    FragA at;
    attf_a_pairs(at, C, tld, ks * 8, m0, lane);
#pragma unroll
    for (int n = 0; n < AW_C / 8; ++n) {
      FragB bx;
      attf_b_pairs(bx, X, Aw<float>::LD, ks * 8, n * 8, lane);
      mma3(o[n], at, bx);
    }
  }
}

// Forward up to 32 queries and keys: a warp a (sentence, head), MT / KT m16
// blocks of queries / keys. Step s of a unit loads chunk s of q and k (s <
// nc; the key mask with step 0) or chunk s - nc of v into ring slot s % 2,
// 2 nc steps a unit.
template <typename T, int MT, int KT>
__global__ void __launch_bounds__(32 * ATT_WARPS)
    attention_wide_short_kernel(AttnArgs<T> a, int flags) {
  using M = Aw<T>;
  constexpr int LD = M::LD, NT = 2 * KT;
  extern __shared__ __align__(16) unsigned char aws_smem[];
  const bool vec = flags & ATL_VEC, wm = flags & ATL_WHERE_MASK;
  const AwsPlan P = aws_plan<T>(a.s_q, a.s_k, false);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  unsigned char* mine = aws_smem + (size_t)warp * P.bytes;
  T* ring = reinterpret_cast<T*>(mine);
  int* msk = reinterpret_cast<int*>(mine + P.bytes) - ATT_MAX_S;
  aws_init(mine, P.bytes, msk, a.key_mask == nullptr, lane);
  const int nc = aw_chunks(a.hd), total = a.batch * a.nh, stride = gridDim.x * nw;
  auto issue = [&](int u, int s) {
    if (u < total) {
      const int b = u / a.nh, h = u - b * a.nh, c0 = (s < nc ? s : s - nc) * AW_C;
      const size_t col = (size_t)h * a.hd;
      T* sl = ring + (s & 1) * P.slot;
      if (s < nc)
        aw_load(sl, a.q + (size_t)b * a.s_q * a.q_ld + col, a.q_ld, 0, a.s_q, a.s_q, c0, a.hd, vec,
                lane, 32);
      aw_load(sl + P.tq, (s < nc ? a.k : a.v) + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, 0,
              a.s_k, a.s_k, c0, a.hd, vec, lane, 32);
      if (s == 0 && a.key_mask != nullptr && lane < a.s_k)
        cp_async4(msk + lane, a.key_mask + b * a.s_k + lane);
    }
    cp_commit();
  };
  int u = blockIdx.x * nw + warp;
  issue(u, 0);
  for (; u < total; u += stride) {
    const int b = u / a.nh, h = u - b * a.nh;
    float sc[MT][NT][4] = {};
    for (int s = 0; s < nc; ++s) {
      issue(u, s + 1);  // s + 1 == nc: v's chunk 0
      cp_wait<1>();
      __syncwarp();
      const T* sl = ring + (s & 1) * P.slot;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        M::template abt<NT>(sc[mt], sl + mt * 16 * LD, sl + P.tq, lane);
      __syncwarp();
    }
    const uint32_t op = a.op_base + h;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        atl_probs(sc[mt], r, mt * 16 + (lane >> 2) + 8 * r, a, msk, wm, b, op, lane & 3);
    T* out = a.out + (size_t)b * a.s_q * a.out_ld + (size_t)h * a.hd;
    for (int c = 0; c < nc; ++c) {
      const int s = nc + c;
      if (c + 1 < nc)
        issue(u, s + 1);
      else
        issue(u + stride, 0);
      cp_wait<1>();
      __syncwarp();
      T* sl = ring + (s & 1) * P.slot;  // v's chunk c in the k tile; ctx staged in the spent q tile
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float o[AW_C / 8][4] = {};
        M::template mix<NT>(o, sc[mt], sl + P.tq, lane);
        atl_stage<T, AW_C>(sl + mt * 16 * LD, o, lane);
      }
      __syncwarp();
      aws_store(out + c * AW_C, a.out_ld, sl, a.s_q, min(AW_C, a.hd - c * AW_C), vec, lane);
      __syncwarp();
    }
  }
}

// Backward up to 32 queries and keys: a warp a (sentence, head); S and dP
// once for dq, dk and dv. Step s < nc loads chunk s of q, k, g and v (the
// key mask with step 0); step nc + c chunk c of q, k and g, for dq = dS K, dk
// = dS^T Q and dv = (P kappa)^T G.
template <typename T, int MT, int KT>
__global__ void __launch_bounds__(32 * ATT_WARPS)
    attention_wide_short_bwd_kernel(AttnArgs<T> a, int flags) {
  using M = Aw<T>;
  constexpr int LD = M::LD, NT = 2 * KT;
  extern __shared__ __align__(16) unsigned char aws_smem[];
  const bool vec = flags & ATL_VEC;
  const AwsPlan P = aws_plan<T>(a.s_q, a.s_k, true);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  unsigned char* mine = aws_smem + (size_t)warp * P.bytes;
  T* ring = reinterpret_cast<T*>(mine);  // a slot: q, k at tq, g at tq + tk, v at 2 tq + tk
  T* pk = ring + 2 * P.slot;             // P kappa, (query, key) rows at tld
  T* dsc = pk + P.sqp * P.tld;           // dS, the same
  T* stage = dsc + P.sqp * P.tld;
  int* msk = reinterpret_cast<int*>(mine + P.bytes) - ATT_MAX_S;
  aws_init(mine, P.bytes, msk, a.key_mask == nullptr, lane);
  const int nc = aw_chunks(a.hd), total = a.batch * a.nh, stride = gridDim.x * nw;
  const int H = a.nh * a.hd;
  auto issue = [&](int u, int s) {
    if (u < total) {
      const int b = u / a.nh, h = u - b * a.nh, c0 = (s < nc ? s : s - nc) * AW_C;
      const size_t col = (size_t)h * a.hd;
      T* sl = ring + (s & 1) * P.slot;
      aw_load(sl, a.q + (size_t)b * a.s_q * a.q_ld + col, a.q_ld, 0, a.s_q, a.s_q, c0, a.hd, vec,
              lane, 32);
      aw_load(sl + P.tq, a.k + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, 0, a.s_k, a.s_k, c0,
              a.hd, vec, lane, 32);
      aw_load(sl + P.tq + P.tk, a.g + (size_t)b * a.s_q * H + col, H, 0, a.s_q, a.s_q, c0, a.hd,
              vec, lane, 32);
      if (s < nc) {
        aw_load(sl + 2 * P.tq + P.tk, a.v + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, 0, a.s_k,
                a.s_k, c0, a.hd, vec, lane, 32);
        if (s == 0 && a.key_mask != nullptr && lane < a.s_k)
          cp_async4(msk + lane, a.key_mask + b * a.s_k + lane);
      }
    }
    cp_commit();
  };
  int u = blockIdx.x * nw + warp;
  issue(u, 0);
  for (; u < total; u += stride) {
    const int b = u / a.nh, h = u - b * a.nh;
    float sc[MT][NT][4] = {}, dp[MT][NT][4] = {};
    for (int s = 0; s < nc; ++s) {
      issue(u, s + 1);
      cp_wait<1>();
      __syncwarp();
      const T* sl = ring + (s & 1) * P.slot;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        M::template abt<NT>(sc[mt], sl + mt * 16 * LD, sl + P.tq, lane);
        M::template abt<NT>(dp[mt], sl + P.tq + P.tk + mt * 16 * LD, sl + 2 * P.tq + P.tk, lane);
      }
      __syncwarp();
    }

    // per query row: p, dp kappa, P kappa into pk, t, then dS (in dp and dsc)
    const uint32_t op = a.op_base + h;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = mt * 16 + g8 + 8 * r;
        const bool row = i < a.s_q;
        const float mx = att_scores<false>(sc[mt], r, i, a, msk, lane);
        const float z = att_exp(sc[mt], r, mx, a.s_k, lane);
        const float rz = rcp_rn(z);
        const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
        float t = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float pd[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int j = nt * 8 + 2 * t4 + c;
            float p = 0.0f, d = 0.0f, kap = 1.0f;
            if (row && j < a.s_k) {
              p = div_rn(sc[mt][nt][2 * r + c], z, rz);
              d = dp[mt][nt][2 * r + c];
              if (a.drop.on) {
                kap = dropout_keep(rt, j, a.drop);
                d *= kap;
              }
              t += d * p;
            }
            sc[mt][nt][2 * r + c] = p;
            dp[mt][nt][2 * r + c] = d;
            pd[c] = a.drop.on ? p * kap : p;
          }
          M::put(pk + i * P.tld + nt * 8 + 2 * t4, pd[0], pd[1]);
        }
        t = quad_sum(t);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            dp[mt][nt][2 * r + c] = sc[mt][nt][2 * r + c] * (dp[mt][nt][2 * r + c] - t) * a.scale;
          M::put(dsc + i * P.tld + nt * 8 + 2 * t4, dp[mt][nt][2 * r], dp[mt][nt][2 * r + 1]);
        }
      }
    __syncwarp();

    T* dqb = a.out + (size_t)b * a.s_q * a.out_ld + (size_t)h * a.hd;
    const size_t kv_off = (size_t)b * a.s_k * a.dkv_ld + (size_t)h * a.hd;
    for (int c = 0; c < nc; ++c) {
      const int s = nc + c;
      if (c + 1 < nc)
        issue(u, s + 1);
      else
        issue(u + stride, 0);
      cp_wait<1>();
      __syncwarp();
      const T* sl = ring + (s & 1) * P.slot;
      const int wc = min(AW_C, a.hd - c * AW_C);
      // dq = dS K, dS (rounded to T) from the registers
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float o[AW_C / 8][4] = {};
        M::template mix<NT>(o, dp[mt], sl + P.tq, lane);
        atl_stage<T, AW_C>(stage + mt * 16 * LD, o, lane);
      }
      __syncwarp();
      aws_store(dqb + c * AW_C, a.out_ld, stage, a.s_q, wc, vec, lane);
      __syncwarp();
      // dk = dS^T Q and dv = (P kappa)^T G: key rows, the sums over the queries
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const T* cpy = which == 0 ? dsc : pk;
        const T* X = which == 0 ? sl : sl + P.tq + P.tk;
#pragma unroll
        for (int mk = 0; mk < KT; ++mk) {
          float o[AW_C / 8][4] = {};
          aws_mix_t<MT>(o, cpy, P.tld, mk * 16, X, lane);
          atl_stage<T, AW_C>(stage + mk * 16 * LD, o, lane);
        }
        __syncwarp();
        aws_store((which == 0 ? a.dk : a.dv) + kv_off + c * AW_C, a.dkv_ld, stage, a.s_k, wc, vec,
                  lane);
        __syncwarp();
      }
    }
  }
}

// ------------------------------------------------------ past 32 tokens

template <typename T>
constexpr int aw_bytes() {  // the ring's slots of two 64-row chunk tiles, the key mask
  return 2 * AW_STAGES * ATL_TILE * Aw<T>::LD * static_cast<int>(sizeof(T)) + ATL_MASK_BYTES;
}

// a 64-row chunk tile (rows row0.. of src, zero past `rows`), by the block
template <typename T>
__device__ __forceinline__ void aw_tile(T* dst, const T* src, int ld, int row0, int rows, int c0,
                                        int hd, bool vec) {
  aw_load(dst, src, ld, row0, ATL_TILE, rows, c0, hd, vec, threadIdx.x, ATL_THREADS);
}

// acc += the warp's 16 rows of A times B's 64 rows, transposed, over one
// chunk (a ragged tile's zero rows give scores that the masks drop)
template <typename T>
__device__ __forceinline__ void aw_abt(float (&acc)[ATL_TILE / 8][4], const T* A, const T* B,
                                       int lane) {
  Aw<T>::template abt<ATL_TILE / 8>(acc, A, B, lane);
}

// o += p X over X's 64 rows (p is 0 past the real ones, X's rows there 0)
template <typename T>
__device__ __forceinline__ void aw_mix(float (&o)[AW_C / 8][4], const float (&p)[ATL_TILE / 8][4],
                                       const T* X, int lane) {
  Aw<T>::template mix<ATL_TILE / 8>(o, p, X, lane);
}

// A warp's 16 rows of one output chunk (the accumulators o) out through its
// own 16 rows of `rows` (row stride LD) to rows row0.. of dst (row stride
// ld), its wc columns, those below n_rows
template <typename T>
__device__ __forceinline__ void aw_put(T* dst, int ld, T* rows, const float (&o)[AW_C / 8][4],
                                       int row0, int n_rows, int wc, bool vec, int lane) {
  atl_stage<T, AW_C>(rows, o, lane);
  __syncwarp();
  atl_store<T, Aw<T>::LD>(dst, ld, rows, row0, n_rows, wc, vec, lane);
  __syncwarp();
}

// Forward: block (sentence, head, query tile, output group). Steps: with
// more than one key tile, sweep 1's nc score steps a key tile (chunk c of q
// and of the key tile's k: the rows' max and sum); then, a key tile at a
// time, nc score steps and a step a held chunk of its v (p V).
template <typename T, int G>
__global__ void __launch_bounds__(ATL_THREADS) attention_wide_kernel(AttnArgs<T> a, int flags) {
  constexpr int LD = Aw<T>::LD, TILE = ATL_TILE * LD, NT = ATL_TILE / 8;
  extern __shared__ __align__(16) unsigned char atl_smem[];
  const bool vec = flags & ATL_VEC, wm = flags & ATL_WHERE_MASK, one = flags & ATW_ONE;
  const int nc = aw_chunks(a.hd), nqt = atl_tiles(a.s_q), gc = one ? 1 : (nc + G - 1) / G;
  T* ring = reinterpret_cast<T*>(atl_smem);  // slot x: A at ring + 2 x TILE, B after it
  int* msk = reinterpret_cast<int*>(ring + 2 * AW_STAGES * TILE);
  const int oc0 = (blockIdx.x % gc) * G, rest = blockIdx.x / gc;
  const int ng = one ? nc : min(G, nc - oc0);
  const int bh = rest / nqt, i0 = (rest - bh * nqt) * ATL_TILE;
  const int b = bh / a.nh, h = bh - b * a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const size_t col = (size_t)h * a.hd;
  const T* qb = a.q + (size_t)b * a.s_q * a.q_ld + col;
  const T* kb = a.k + (size_t)b * a.s_k * a.kv_ld + col;
  const T* vb = a.v + (size_t)b * a.s_k * a.kv_ld + col;
  T* ob = a.out + (size_t)b * a.s_q * a.out_ld + col;
  int n = 1;  // key tiles, from the mask (step 0 is the same for any n)
  auto issue = [&](int k) {
    const int pre = n > 1 ? n * nc : 0, per = nc + ng;
    if (k < pre + n * per) {
      T* sl = ring + 2 * (k % AW_STAGES) * TILE;
      const int span = k < pre ? nc : per;
      int c = k < pre ? k : k - pre;
      const int t = c / span;
      c -= t * span;
      if (c < nc) {
        aw_tile(sl, qb, a.q_ld, i0, a.s_q, c * AW_C, a.hd, vec);
        aw_tile(sl + TILE, kb, a.kv_ld, t * ATL_TILE, a.s_k, c * AW_C, a.hd, vec);
      } else {
        aw_tile(sl + TILE, vb, a.kv_ld, t * ATL_TILE, a.s_k, (oc0 + c - nc) * AW_C, a.hd, vec);
      }
    }
    cp_commit();
  };
  for (int k0 = 0; k0 < AW_STAGES - 1; ++k0) issue(k0);  // the same steps for any n
  n = atl_key_tiles(a, i0, atl_mask(msk, a, b));
  int k = 0;
  auto begin = [&]() {  // step k's tiles, the next steps' loads in flight
    issue(k + AW_STAGES - 1);
    cp_wait<AW_STAGES - 1>();
    __syncthreads();
    return ring + 2 * (k % AW_STAGES) * TILE;
  };
  auto end = [&]() {  // the slot is free for step k + AW_STAGES
    __syncthreads();
    ++k;
  };
  const int iw = i0 + warp * 16 + g8;  // the warp's rows iw and iw + 8
  const bool live = i0 + warp * 16 < a.s_q;
  const uint32_t op = a.op_base + h;
  auto score_tile = [&](int j0, float (&sc)[NT][4]) {  // q k^T over every chunk
    for (int c = 0; c < nc; ++c) {
      const T* sl = begin();
      if (live) aw_abt(sc, sl + warp * 16 * LD, sl + TILE, lane);
      end();
    }
  };
  auto put = [&](int oc, T* rows, const float (&o)[AW_C / 8][4]) {
    aw_put(ob + oc * AW_C, a.out_ld, rows, o, i0 + warp * 16, a.s_q, min(AW_C, a.hd - oc * AW_C),
           vec, lane);
  };

  if (n == 1) {
    // one key tile: its scores once, then every held chunk goes out as it is
    // mixed, staged in the warp's rows of the slot's spent q tile
    float sc[NT][4] = {};
    score_tile(0, sc);
#pragma unroll
    for (int r = 0; r < 2; ++r) atl_probs(sc, r, iw + 8 * r, a, msk, wm, b, op, t4);
    for (int c = 0; c < ng; ++c) {
      T* sl = begin();
      if (live) {
        float o[AW_C / 8][4] = {};
        aw_mix(o, sc, sl + TILE, lane);
        put(oc0 + c, sl + warp * 16 * LD, o);
      }
      end();
    }
    return;
  }

  // sweep 1: each row's max and sum of exp over the real keys, online
  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.0f, 0.0f};
  for (int t = 0; t < n; ++t) {
    const int j0 = t * ATL_TILE;
    float sc[NT][4] = {};
    score_tile(j0, sc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + 8 * r;
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
    }
  }
  // sweep 2: p = e / z (#13: e * (1 / z)) with the final max and sum, times
  // the keep mask, into every held chunk
  float o[G][AW_C / 8][4] = {};
  for (int t = 0; t < n; ++t) {
    const int j0 = t * ATL_TILE;
    float sc[NT][4] = {};
    score_tile(j0, sc);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + 8 * r;
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
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (gg < ng) {
        const T* sl = begin();
        if (live) aw_mix(o[gg], sc, sl + TILE, lane);
        end();
      }
  }
  if (live) {  // every load is done and the ring idle
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (gg < ng) put(oc0 + gg, ring + warp * 16 * LD, o[gg]);
  }
}

// Backward, dq: block (sentence, head, query tile, dq group). Score steps
// come in pairs, chunk c of q and of the key tile's k (S), then of g and of
// its v (dP); sweep 2 adds a step a held chunk of the key tile's k (dS K).
// The blocks of the first group write each query row's (max, sum of exp z,
// 1 / z, t) to a.stats for attention_wide_dkv_kernel.
template <typename T, int G>
__global__ void __launch_bounds__(ATL_THREADS) attention_wide_dq_kernel(AttnArgs<T> a, int flags) {
  constexpr int LD = Aw<T>::LD, TILE = ATL_TILE * LD, NT = ATL_TILE / 8;
  extern __shared__ __align__(16) unsigned char atl_smem[];
  const bool vec = flags & ATL_VEC, one = flags & ATW_ONE;
  const int nc = aw_chunks(a.hd), nqt = atl_tiles(a.s_q), gc = one ? 1 : (nc + G - 1) / G;
  T* ring = reinterpret_cast<T*>(atl_smem);
  int* msk = reinterpret_cast<int*>(ring + 2 * AW_STAGES * TILE);
  const int oc0 = (blockIdx.x % gc) * G, rest = blockIdx.x / gc;
  const int ng = one ? nc : min(G, nc - oc0);
  const int bh = rest / nqt, i0 = (rest - bh * nqt) * ATL_TILE;
  const int b = bh / a.nh, h = bh - b * a.nh;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const size_t col = (size_t)h * a.hd;
  const int H = a.nh * a.hd;
  const T* qb = a.q + (size_t)b * a.s_q * a.q_ld + col;
  const T* kb = a.k + (size_t)b * a.s_k * a.kv_ld + col;
  const T* vb = a.v + (size_t)b * a.s_k * a.kv_ld + col;
  const T* gb = a.g + (size_t)b * a.s_q * H + col;
  T* dqb = a.out + (size_t)b * a.s_q * a.out_ld + col;
  int n = 1;
  auto issue = [&](int k) {
    const int sc2 = 2 * nc, pre = n > 1 ? n * sc2 : 0, per = sc2 + ng;
    if (k < pre + n * per) {
      T* sl = ring + 2 * (k % AW_STAGES) * TILE;
      const int span = k < pre ? sc2 : per;
      int c = k < pre ? k : k - pre;
      const int t = c / span;
      c -= t * span;
      const int j0 = t * ATL_TILE;
      if (c < sc2) {
        const int c0 = (c >> 1) * AW_C;
        aw_tile(sl, c & 1 ? gb : qb, c & 1 ? H : a.q_ld, i0, a.s_q, c0, a.hd, vec);
        aw_tile(sl + TILE, c & 1 ? vb : kb, a.kv_ld, j0, a.s_k, c0, a.hd, vec);
      } else {
        aw_tile(sl + TILE, kb, a.kv_ld, j0, a.s_k, (oc0 + c - sc2) * AW_C, a.hd, vec);
      }
    }
    cp_commit();
  };
  for (int k0 = 0; k0 < AW_STAGES - 1; ++k0) issue(k0);  // the same steps for any n
  n = atl_key_tiles(a, i0, atl_mask(msk, a, b));
  int k = 0;
  auto begin = [&]() {
    issue(k + AW_STAGES - 1);
    cp_wait<AW_STAGES - 1>();
    __syncthreads();
    return ring + 2 * (k % AW_STAGES) * TILE;
  };
  auto end = [&]() {
    __syncthreads();
    ++k;
  };
  const int iw = i0 + warp * 16 + g8;
  const bool live = i0 + warp * 16 < a.s_q;
  const uint32_t op = a.op_base + h;
  auto keep_stats = [&](int i, float m, float z, float rz, float t) {
    if (oc0 == 0 && t4 == 0 && i < a.s_q)
      *reinterpret_cast<float4*>(a.stats + ((size_t)bh * a.s_q + i) * 4) = make_float4(m, z, rz, t);
  };
  auto score_tile = [&](int j0, float (&sc)[NT][4], float (&dp)[NT][4]) {  // S and dP
    for (int c = 0; c < nc; ++c) {
      const T* sl = begin();
      if (live) aw_abt(sc, sl + warp * 16 * LD, sl + TILE, lane);
      end();
      sl = begin();
      if (live) aw_abt(dp, sl + warp * 16 * LD, sl + TILE, lane);
      end();
    }
  };
  auto put = [&](int oc, T* rows, const float (&o)[AW_C / 8][4]) {
    aw_put(dqb + oc * AW_C, a.out_ld, rows, o, i0 + warp * 16, a.s_q, min(AW_C, a.hd - oc * AW_C),
           vec, lane);
  };

  if (n == 1) {
    // one key tile: s and dp once; ds = p (dp kappa - t) * scale, rounded at
    // the mix; then ds K, every held chunk out as it is mixed
    float sc[NT][4] = {}, dp[NT][4] = {};
    score_tile(0, sc, dp);
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
          sc[nt][2 * r + c] = i < a.s_q && j < a.s_k ? p * (dp[nt][2 * r + c] - t) * a.scale : 0.0f;
        }
    }
    for (int c = 0; c < ng; ++c) {
      T* sl = begin();
      if (live) {
        float o[AW_C / 8][4] = {};
        aw_mix(o, sc, sl + TILE, lane);
        put(oc0 + c, sl + warp * 16 * LD, o);
      }
      end();
    }
    return;
  }

  // sweep 1: max, sum of exp and the sum of e * dp * kappa, online
  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.0f, 0.0f}, tau[2] = {0.0f, 0.0f};
  for (int t = 0; t < n; ++t) {
    const int j0 = t * ATL_TILE;
    float sc[NT][4] = {}, dp[NT][4] = {};
    score_tile(j0, sc, dp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + 8 * r;
      const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
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
    }
  }
  float tt[2], rz[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rz[r] = rcp_rn(z[r]);
    tt[r] = div_rn(tau[r], z[r], rz[r]);
    keep_stats(iw + 8 * r, m[r], z[r], rz[r], tt[r]);
  }

  // sweep 2: ds = p (dp kappa - t) * scale, rounded at the mix; dq += ds K
  float dq[G][AW_C / 8][4] = {};
  for (int t = 0; t < n; ++t) {
    const int j0 = t * ATL_TILE;
    float sc[NT][4] = {}, dp[NT][4] = {};
    score_tile(j0, sc, dp);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = iw + 8 * r;
      const uint32_t rt = dropout_row_term(b * a.s_q + i, op, a.drop.seed);
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
            ds = p * (d - tt[r]) * a.scale;
          }
          sc[nt][2 * r + c] = ds;
        }
    }
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (gg < ng) {
        const T* sl = begin();
        if (live) aw_mix(dq[gg], sc, sl + TILE, lane);
        end();
      }
  }
  if (live) {
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (gg < ng) put(oc0 + gg, ring + warp * 16 * LD, dq[gg]);
  }
}

// Backward, dk and dv: block (sentence, head, key tile, group of chunks of
// both), from the query rows' statistics that attention_wide_dq_kernel
// wrote, the scores as K Q^T (key rows). For each query tile, score steps
// in pairs (chunk c of the key tile's k and of the query tile's q: P^T,
// then of v and g: dP^T), then a step a held chunk (g and q: dv += (P
// kappa)^T G and dk += dS^T Q).
template <typename T, int G>
__global__ void __launch_bounds__(ATL_THREADS) attention_wide_dkv_kernel(AttnArgs<T> a,
                                                                           int flags) {
  constexpr int LD = Aw<T>::LD, TILE = ATL_TILE * LD, NT = ATL_TILE / 8;
  extern __shared__ __align__(16) unsigned char atl_smem[];
  const bool vec = flags & ATL_VEC, one = flags & ATW_ONE;
  const int nc = aw_chunks(a.hd), nqt = atl_tiles(a.s_q), nkt = atl_tiles(a.s_k);
  const int gc = one ? 1 : (nc + G - 1) / G;
  T* ring = reinterpret_cast<T*>(atl_smem);
  int* msk = reinterpret_cast<int*>(ring + 2 * AW_STAGES * TILE);
  const int oc0 = (blockIdx.x % gc) * G, rest = blockIdx.x / gc;
  const int ng = one ? nc : min(G, nc - oc0);
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
  const int steps = nqt - skip, sc2 = 2 * nc, per = sc2 + ng;
  auto tile0 = [&](int s) { return (s < lo ? s : s + skip) * ATL_TILE; };
  auto issue = [&](int k) {
    if (k < steps * per) {
      T* sl = ring + 2 * (k % AW_STAGES) * TILE;
      const int s = k / per, c = k - s * per, i0 = tile0(s);
      if (c < sc2) {
        const int c0 = (c >> 1) * AW_C;
        aw_tile(sl, c & 1 ? vb : kb, a.kv_ld, j0, a.s_k, c0, a.hd, vec);
        aw_tile(sl + TILE, c & 1 ? gb : qb, c & 1 ? H : a.q_ld, i0, a.s_q, c0, a.hd, vec);
      } else {
        const int c0 = (oc0 + c - sc2) * AW_C;
        aw_tile(sl, gb, H, i0, a.s_q, c0, a.hd, vec);
        aw_tile(sl + TILE, qb, a.q_ld, i0, a.s_q, c0, a.hd, vec);
      }
    }
    cp_commit();
  };
  for (int k0 = 0; k0 < AW_STAGES - 1; ++k0) issue(k0);
  int k = 0;
  auto begin = [&]() {
    issue(k + AW_STAGES - 1);
    cp_wait<AW_STAGES - 1>();
    __syncthreads();
    return ring + 2 * (k % AW_STAGES) * TILE;
  };
  auto end = [&]() {
    __syncthreads();
    ++k;
  };
  const int jw = j0 + warp * 16 + g8;  // the warp's keys jw and jw + 8
  const bool live = j0 + warp * 16 < a.s_k;
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) valid[r] = jw + 8 * r < a.s_k && msk[jw + 8 * r] > 0;
  const uint32_t op = a.op_base + h;
  auto put = [&](T* out, int oc, T* rows, const float (&o)[AW_C / 8][4]) {
    aw_put(out + kv_off + oc * AW_C, a.dkv_ld, rows, o, j0 + warp * 16, a.s_k,
           min(AW_C, a.hd - oc * AW_C), vec, lane);
  };
  // query tile s's P kappa (in pt, dv's A operand) and dS (in dpt, dk's)
  auto score_tile = [&](int i0, float (&pt)[NT][4], float (&dpt)[NT][4]) {
    for (int c = 0; c < nc; ++c) {
      const T* sl = begin();
      if (live) aw_abt(pt, sl + warp * 16 * LD, sl + TILE, lane);
      end();
      sl = begin();
      if (live) aw_abt(dpt, sl + warp * 16 * LD, sl + TILE, lane);
      end();
    }
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
  };

  if (steps <= 1) {
    // one query tile reaches this key tile (or none: zeros): every held
    // chunk of dv and dk goes out as it is mixed, staged in the warp's rows
    // of the slot once every warp has read it
    float pt[NT][4] = {}, dpt[NT][4] = {};
    if (steps == 1) score_tile(tile0(0), pt, dpt);
    const int i0 = tile0(0);
    for (int c = 0; c < ng; ++c) {
      T* sl = steps == 1 ? begin() : ring;
      float ov[AW_C / 8][4] = {}, ok[AW_C / 8][4] = {};
      if (live && steps == 1) {
        aw_mix(ov, pt, sl, lane);
        aw_mix(ok, dpt, sl + TILE, lane);
      }
      __syncthreads();
      if (live) {
        put(a.dv, oc0 + c, sl + warp * 16 * LD, ov);
        put(a.dk, oc0 + c, sl + TILE + warp * 16 * LD, ok);
      }
      if (steps == 1) end();
      else __syncthreads();
    }
    return;
  }

  float dk[G][AW_C / 8][4] = {}, dv[G][AW_C / 8][4] = {};
  for (int s = 0; s < steps; ++s) {
    const int i0 = tile0(s);
    float pt[NT][4] = {}, dpt[NT][4] = {};
    score_tile(i0, pt, dpt);
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (gg < ng) {
        const T* sl = begin();
        if (live) {
          aw_mix(dv[gg], pt, sl, lane);
          aw_mix(dk[gg], dpt, sl + TILE, lane);
        }
        end();
      }
  }
  if (live) {
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (gg < ng) {
        put(a.dv, oc0 + gg, ring + warp * 16 * LD, dv[gg]);
        put(a.dk, oc0 + gg, ring + warp * 16 * LD, dk[gg]);
      }
  }
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

// head_dim past 128, up to 32 queries and keys: the short wide kernel for
// the call's m16 blocks of queries and keys, on att_launch's persistent grid
template <typename T, bool BWD, int MT, int KT>
int aws_launch(const AttnArgs<T>& a, int flags, cudaStream_t st) {
  const int bytes = aws_plan<T>(a.s_q, a.s_k, BWD).bytes;
  if constexpr (BWD)
    return att_launch<AttnArgs<T>, attention_wide_short_bwd_kernel<T, MT, KT>>(a, bytes, st, flags);
  else
    return att_launch<AttnArgs<T>, attention_wide_short_kernel<T, MT, KT>>(a, bytes, st, flags);
}

template <typename T, bool BWD>
int aws_run(const AttnArgs<T>& a, int flags, cudaStream_t st) {
  switch ((a.s_q > 16) * 2 + (a.s_k > 16)) {
    case 0: return aws_launch<T, BWD, 1, 1>(a, flags, st);
    case 1: return aws_launch<T, BWD, 1, 2>(a, flags, st);
    case 2: return aws_launch<T, BWD, 2, 1>(a, flags, st);
    default: return aws_launch<T, BWD, 2, 2>(a, flags, st);
  }
}

// head_dim past 128: up to 32 queries and keys a warp a (sentence, head);
// past that a block a tile and a group of output chunks, every chunk up to
// 64 keys (queries for dk / dv: ATW_ONE)
template <typename T>
int atw_fwd_run(const AttnArgs<T>& a, int flags, cudaStream_t st) {
  if (attention_short(a.s_q, a.s_k)) return aws_run<T, false>(a, flags, st);
  const bool one = a.s_k <= ATL_TILE;
  const int groups = one ? 1 : (aw_chunks(a.hd) + AW_G_FWD - 1) / AW_G_FWD;
  return atl_launch<T, attention_wide_kernel<T, AW_G_FWD>>(
      a, flags | (one ? ATW_ONE : 0), a.batch * a.nh * atl_tiles(a.s_q) * groups, aw_bytes<T>(),
      st);
}

template <typename T>
int atw_bwd_run(const AttnArgs<T>& a, int flags, cudaStream_t st) {
  if (attention_short(a.s_q, a.s_k)) return aws_run<T, true>(a, flags, st);
  if (a.stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int nc = aw_chunks(a.hd);
  const bool one_k = a.s_k <= ATL_TILE, one_q = a.s_q <= ATL_TILE;
  const int gq = one_k ? 1 : (nc + AW_G_DQ - 1) / AW_G_DQ;
  const int gkv = one_q ? 1 : (nc + AW_G_DKV - 1) / AW_G_DKV;
  const int e = atl_launch<T, attention_wide_dq_kernel<T, AW_G_DQ>>(
      a, flags | (one_k ? ATW_ONE : 0), a.batch * a.nh * atl_tiles(a.s_q) * gq, aw_bytes<T>(), st);
  if (e != 0) return e;
  return atl_launch<T, attention_wide_dkv_kernel<T, AW_G_DKV>>(
      a, flags | (one_q ? ATW_ONE : 0), a.batch * a.nh * atl_tiles(a.s_k) * gkv, aw_bytes<T>(),
      st);
}

template <typename T>
int atl_fwd(const AttnArgs<T>& a, bool where_mask, cudaStream_t st) {
  if (!attention_fits(a.s_q, a.s_k, a.hd)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch * a.nh <= 0) return 0;
  const int flags = (att_vec(a, false) ? ATL_VEC : 0) | (where_mask ? ATL_WHERE_MASK : 0);
  if (a.hd > ATT_MAX_HD) return atw_fwd_run(a, flags, st);
  return a.hd <= 64 ? atl_fwd_run<T, 64>(a, flags, st) : atl_fwd_run<T, 128>(a, flags, st);
}

template <typename T>
int atl_bwd(const AttnArgs<T>& a, cudaStream_t st) {
  if (!attention_fits(a.s_q, a.s_k, a.hd)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch * a.nh <= 0) return 0;
  const int flags = att_vec(a, true) ? ATL_VEC : 0;
  if (a.hd > ATT_MAX_HD) return atw_bwd_run(a, flags, st);
  if (a.stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
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
