// The layer GEMM in f32 for Hopper (sm_90a): C = epi(op(A) @ op(B)) on f32
// operands, the f32 instance of gemm_sm90.cuh.
//
// Replaces, in f32 (JAX's parity dtype, `compute_dtype="float32"`), the
// products of kindergarten_vq_vae_tpu/ops/layer_pallas.py `_layer_fwd_kernel`
// (l.489: `_mm` with the bias and the GELU of `_gelu_fwd`) and
// `_layer_bwd_kernel` (l.552: `_mm_nt` with the residual add or the GELU
// gradient of `_gelu_grad`, and `_mm_tn` for the weight gradients), which run
// in the run's compute dtype. Entry point kvq_gemm_f32 (ops/gemm.py `gemm`
// on f32 tensors); the layer forward (layer_fwd.cu) calls run_gemm.
//
// It also carries the f32 instance of the fused MLM head + CE
// (kindergarten_vq_vae_tpu/ops/head_ce_pallas.py `_fwd_kernel` l.67, #9, and
// `_bwd_kernel` l.179, #10, in f32, where their casts to x's dtype are
// identities): run_ce computes the NT product x @ E^T with a CE epilogue,
// l = acc + b in f32 (l.85), and head_ce.cu's f32 entries add the partials'
// merge, the store-mode gradient pass, dx = g @ E (NN, K = V) and the table
// gradient g^T @ x (TN split-K) on run_gemm.
//
// Precision: f32 is the parity dtype, so single-pass TF32 (a 10-bit
// mantissa, ~5e-4 relative a product) is not enough. Each operand is split
// into a TF32 high part and the TF32 rounding of its remainder, x = big +
// small to ~22 bits, and the tile accumulates small*big + big*small +
// big*big in f32 (3xTF32): within a few 1e-7 of an f32 product, the
// small*small term (2^-22) dropped.
//
// What bounds it on the H100: operations. At the step's 24,576 rows a
// product of K = 768 or 3,072 does ~100 FLOP a byte in f32, above the ~20 of
// the f32 units' balance point; 3xTF32 runs three TF32 products (494.7
// TFLOP/s dense) for one f32 one, a bound of 165 TFLOP/s against the FFMA
// units' 67. The design is the simple one of mma.sync before wgmma:
// - a 128 x 128 CTA tile over 32-deep slices of K, 8 warps of 64 x 32, a
//   two-stage ring of 16-byte cp.async copies (zero-filled at the ragged
//   edges), two CTAs an SM;
// - mma.sync m16n8k8 tf32 with f32 accumulation, each k8 step's three
//   products in a fresh accumulator added to the tile's by a rounded FADD
//   (the tensor cores' own accumulation drifts over a long K), fragments
//   read from shared memory by hand. wgmma's tf32 form takes K-major operands only (its
//   transpose bits exist for 16-bit types), so the bf16 GEMM's MN-major reads
//   do not carry over; here the tiles are stored as they lie in memory, (m,
//   k) or (k, m) for A, (k, n) or (n, k) for B, and NN, NT and TN differ only
//   in the index that reads a fragment. Row strides of 36 and 136 floats
//   keep every fragment read free of bank conflicts;
// - the epilogue runs on the accumulator registers and writes f32 pairs:
//   bias, GELU (with the pre-GELU u), the residual add, the GELU gradient
//   with du's column sums per 128-row tile (rows in a fixed order, then the
//   tile's two warps, then colparts_reduce over the tiles in order), or a
//   split-K partial of a weight gradient, summed in a fixed order by
//   splitk_reduce_kernel. Every sum is the same bits in every run;
// - the CE epilogues (EPI_CE_FWD / EPI_CE_BWD, on the NT product with the
//   table as B, 128 x 128 tiles: HEAD_TILE_N) reduce each row of the tile
//   over the thread's 8 columns, then the warp's 4 lanes of the row by
//   butterflies, then the tile's 4 column warps in order through the spent
//   stage buffers: per (vocab tile, row) partials (max, sum of exp, target
//   logit, first argmax; head_ce.cu merges them in vocab-tile order), and
//   store mode's f32 logits; or g = (exp(l - lse) - onehot) * scale and one
//   dbias partial per (128-row tile, column), summed as the GELU-gradient
//   column sums are (each thread's rows in order, a butterfly over g, the
//   tile's two row warps), which head_ce.cu's store-mode pass repeats to the
//   bit. Columns at or past V are -inf logits and 0 gradients, written 0 up
//   to the padded leading dimension; V may be odd.
//
// Rows whose extent is not a multiple of 4 (the vocabulary's 30,522 as g's K
// in dx, or as the table gradient's M) are read on to the next multiple of 4
// inside their leading dimension: the caller keeps those pad elements zero
// (g's pad columns are written 0), and the GEMM zero-fills B's rows past K,
// so they add nothing.

#include <climits>
#include <cstdint>

#include "gemm_f32.cuh"
#include "layer_common.cuh"
#include "layernorm.cuh"

namespace kvq {
namespace f32gemm {

namespace {

constexpr int THREADS = 256;
constexpr int LD_K = TILE_K + 4;   // a tile row along K: 32 floats + 4
constexpr int LD_MN = TILE_M + 8;  // a tile row along M or N: 128 floats + 8
constexpr int TILE_FLOATS = TILE_M * LD_K > TILE_K * LD_MN ? TILE_M * LD_K : TILE_K * LD_MN;
constexpr int STAGE_FLOATS = 2 * TILE_FLOATS;  // A's and B's tiles
constexpr int SMEM_BYTES = 2 * STAGE_FLOATS * 4;

struct Params {
  const float* A;
  const float* B;
  int lda, ldb, M, N, K, kchunk;
  float* C;  // EPI_PARTIAL: the split-K workspace (splits, M, N)
  int ldc;
  float* C2;
  int ldc2;
  const float* aux;
  int ld_aux;
  const float* bias;
  float* colpart;  // (ceil(M / 128), N): du's column sums of each 128-row tile
  // the CE epilogues: targets (M,); EPI_CE_BWD also lse and scale (M,);
  // part_f the (3, tiles of N, M) partials (EPI_CE_FWD, with part_i (tiles of
  // N, M)) or the (ceil(M / 128), N) dbias partials (EPI_CE_BWD)
  const int* targets;
  const float* lse;
  const float* scale;
  float* part_f;
  int* part_i;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // the tf32 value, its 13 low bits zero
}

// x = big + small: the TF32 rounding of x and that of its remainder
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a (16 x 8, row) b (8 x 8, col), tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A (m, k) and B (k, n) of a stage's tiles, as each is stored
template <bool A_T>
__device__ __forceinline__ float tile_a(const float* s, int m, int k) {
  return A_T ? s[k * LD_MN + m] : s[m * LD_K + k];
}

template <bool B_T>
__device__ __forceinline__ float tile_b(const float* s, int k, int n) {
  return B_T ? s[n * LD_K + k] : s[k * LD_MN + n];
}

// An operand's tile by 16-byte copies. ALONG_K: the operand lies (rows, K)
// and the tile is its 128 rows r0.. by TILE_K columns k0..; otherwise it lies
// (K, rows) and the tile is its TILE_K rows k0.. by 128 columns r0.. .
// Copies past `rows` or `kend` are zero-filled.
template <bool ALONG_K>
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld, int r0, int rows,
                                          int k0, int kend, int tid) {
#pragma unroll
  for (int i = 0; i < TILE_M * TILE_K / 4 / THREADS; ++i) {
    const int c = tid + i * THREADS;
    if constexpr (ALONG_K) {  // 128 rows of 8 chunks
      const int r = c >> 3, kc = (c & 7) << 2;
      const bool ok = r0 + r < rows && k0 + kc < kend;
      cp_async16(s + r * LD_K + kc, ok ? g + (size_t)(r0 + r) * ld + k0 + kc : g, ok);
    } else {  // 32 rows of 32 chunks
      const int r = c >> 5, mc = (c & 31) << 2;
      const bool ok = k0 + r < kend && r0 + mc < rows;
      cp_async16(s + r * LD_MN + mc, ok ? g + (size_t)(k0 + r) * ld + r0 + mc : g, ok);
    }
  }
}

template <bool A_T, bool B_T>
__device__ __forceinline__ void load_stage(float* s, const Params& p, int m0, int n0, int k0,
                                           int kend, int tid) {
  load_tile<!A_T>(s, p.A, p.lda, m0, p.M, k0, kend, tid);
  load_tile<B_T>(s + TILE_FLOATS, p.B, p.ldb, n0, p.N, k0, kend, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool A_T, bool B_T>
__device__ __forceinline__ void compute_stage(const float* s, float (&acc)[4][4][4], int wm,
                                              int wn, int g, int t) {
  const float* sa = s;
  const float* sb = s + TILE_FLOATS;
#pragma unroll
  for (int kk = 0; kk < TILE_K; kk += 8) {
    uint32_t bb[4][2], bs[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = wn * 32 + nt * 8 + g;
      split(tile_b<B_T>(sb, kk + t, n), bb[nt][0], bs[nt][0]);
      split(tile_b<B_T>(sb, kk + t + 4, n), bb[nt][1], bs[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int m = wm * 64 + mt * 16 + g;
      uint32_t ab[4], as[4];
      split(tile_a<A_T>(sa, m, kk + t), ab[0], as[0]);
      split(tile_a<A_T>(sa, m + 8, kk + t), ab[1], as[1]);
      split(tile_a<A_T>(sa, m, kk + t + 4), ab[2], as[2]);
      split(tile_a<A_T>(sa, m + 8, kk + t + 4), ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // the three products of this k8 step in a fresh accumulator, the
        // small terms first, then one rounded add into the tile's: the
        // tensor cores' accumulation does not round to nearest, and a chain
        // of it over a long K drifts (PERF.md, the f32 GEMM's precision)
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(d, as, bb[nt][0], bb[nt][1]);
        mma_tf32(d, ab, bs[nt][0], bs[nt][1]);
        mma_tf32(d, ab, bb[nt][0], bb[nt][1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += d[i];
      }
    }
  }
}

// The CE forward epilogue (#9) on the NT product x @ E^T: l = acc + b (N the
// vocabulary; columns at or past it -inf), and each of the tile's rows
// reduced to its partial (module comment); store mode (C not null) also
// writes l at ldc, its pad columns 0.
__device__ __forceinline__ void ce_fwd_epilogue(const Params& p, const float (&acc)[4][4][4],
                                                float* smem, int m0, int n0, int wm, int wn,
                                                int g, int t, int tid) {
  float* red_f = smem;                                        // [4 wn][TILE_M][3]
  int* red_i = reinterpret_cast<int*>(smem + 4 * TILE_M * 3);  // [4 wn][TILE_M]
  float b[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t + c;
      b[nt][c] = col < p.N ? p.bias[col] : 0.0f;
    }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * 64 + mt * 16 + g + 8 * h, row = m0 + rl;
      const bool live = row < p.M;
      const int tgt = live ? p.targets[row] : -1;
      float l[4][2], mx = -INFINITY, tv = 0.0f;
      int first = INT_MAX;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // this thread's columns in increasing order
          const int col = n0 + wn * 32 + nt * 8 + 2 * t + c;
          l[nt][c] = col < p.N ? acc[mt][nt][2 * h + c] + b[nt][c] : -INFINITY;
          if (l[nt][c] > mx) mx = l[nt][c], first = col;
          if (col == tgt && col < p.N) tv = l[nt][c];
        }
      // the row's 32 columns of this warp: lanes t = 0..3
      float wmx = mx;
      wmx = fmaxf(wmx, __shfl_xor_sync(0xffffffffu, wmx, 1));
      wmx = fmaxf(wmx, __shfl_xor_sync(0xffffffffu, wmx, 2));
      int fi = mx == wmx ? first : INT_MAX;
      fi = min(fi, __shfl_xor_sync(0xffffffffu, fi, 1));
      fi = min(fi, __shfl_xor_sync(0xffffffffu, fi, 2));
      float s = 0.0f;
      if (wmx != -INFINITY)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) s += expf(l[nt][c] - wmx);  // 0 at the -inf columns
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      tv += __shfl_xor_sync(0xffffffffu, tv, 1);  // one lane holds it, or none
      tv += __shfl_xor_sync(0xffffffffu, tv, 2);
      if (t == 0) {
        float* r = red_f + (wn * TILE_M + rl) * 3;
        r[0] = wmx, r[1] = s, r[2] = tv;
        red_i[wn * TILE_M + rl] = fi;
      }
      if (live && p.C != nullptr)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn * 32 + nt * 8 + 2 * t;
          if (col < p.ldc)  // ldc even: both columns inside; past N 0
            *reinterpret_cast<float2*>(p.C + (size_t)row * p.ldc + col) =
                make_float2(col < p.N ? l[nt][0] : 0.0f, col + 1 < p.N ? l[nt][1] : 0.0f);
        }
    }
  __syncthreads();
  if (tid < TILE_M && m0 + tid < p.M) {  // the four column warps in order
    Part a{red_f[tid * 3], red_f[tid * 3 + 1], red_f[tid * 3 + 2], red_i[tid]};
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      const float* r = red_f + (w * TILE_M + tid) * 3;
      merge(a, Part{r[0], r[1], r[2], red_i[w * TILE_M + tid]});
    }
    const size_t plane = (size_t)gridDim.x * p.M, o = (size_t)blockIdx.x * p.M + m0 + tid;
    p.part_f[o] = a.m;
    p.part_f[plane + o] = a.s;
    p.part_f[2 * plane + o] = a.t;
    p.part_i[o] = a.i;
  }
}

// The CE backward epilogue (#10, flash mode): l recomputed as
// ce_fwd_epilogue computes it, g = (exp(l - lse) - onehot) * scale (0 at or
// past N) written at ldc with its pad columns 0, and the tile's dbias partial
// of each column: this thread's rows in (mt, h) order, the butterfly over g,
// then the two row warps (head_ce.cu `head_ce_grad_f32_kernel` sums in this
// order).
__device__ __forceinline__ void ce_bwd_epilogue(const Params& p, const float (&acc)[4][4][4],
                                                float* smem, int m0, int n0, int wm, int wn,
                                                int g, int t, int tid) {
  float b[4][2], cs[4][2] = {};
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t + c;
      b[nt][c] = col < p.N ? p.bias[col] : 0.0f;
    }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
      if (row >= p.M) continue;
      const int tgt = p.targets[row];
      const float lse = p.lse[row], sc = p.scale[row];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        float gm[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          gm[c] = col + c < p.N
                      ? ce_grad(acc[mt][nt][2 * h + c] + b[nt][c], lse, col + c == tgt, sc)
                      : 0.0f;
          cs[nt][c] += gm[c];
        }
        if (col < p.ldc)
          *reinterpret_cast<float2*>(p.C + (size_t)row * p.ldc + col) = make_float2(gm[0], gm[1]);
      }
    }
  float* red = smem;  // [2][TILE_N]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = cs[nt][c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[wm * TILE_N + wn * 32 + nt * 8 + 2 * t + c] = v;
    }
  __syncthreads();
  if (tid < TILE_N && n0 + tid < p.N)
    p.part_f[(size_t)blockIdx.y * p.N + n0 + tid] = red[tid] + red[TILE_N + tid];
}

// grid (tiles of N, tiles of M, splits); blockIdx.z takes rows
// [z * kchunk, (z + 1) * kchunk) of K.
template <bool A_T, bool B_T, int EPI>
__global__ void __launch_bounds__(THREADS, 2) gemm_f32_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N;
  const int kbeg = blockIdx.z * p.kchunk;
  const int kend = min(p.K, kbeg + p.kchunk);
  const int nk = kend > kbeg ? (kend - kbeg + TILE_K - 1) / TILE_K : 0;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  if (nk > 0) load_stage<A_T, B_T>(smem, p, m0, n0, kbeg, kend, tid);
  for (int it = 0; it < nk; ++it) {
    if (it + 1 < nk)
      load_stage<A_T, B_T>(smem + ((it + 1) & 1) * STAGE_FLOATS, p, m0, n0,
                           kbeg + (it + 1) * TILE_K, kend, tid);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");  // an empty group: one wait rule
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    compute_stage<A_T, B_T>(smem + (it & 1) * STAGE_FLOATS, acc, wm, wn, g, t);
    __syncthreads();
  }

  // epilogue: thread (g, t) holds rows g, g + 8 of each m16 block, columns
  // 2t, 2t + 1 of each n8 block
  if constexpr (EPI == EPI_CE_FWD) {
    ce_fwd_epilogue(p, acc, smem, m0, n0, wm, wn, g, t, tid);
    return;
  } else if constexpr (EPI == EPI_CE_BWD) {
    ce_bwd_epilogue(p, acc, smem, m0, n0, wm, wn, g, t, tid);
    return;
  }
  float* C = p.C + (EPI == EPI_PARTIAL ? (size_t)blockIdx.z * p.M * p.N : 0);
  float cs[4][2] = {};  // dgelu: du's sums over this thread's rows, by column
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mt * 16 + g + 8 * h;
      if (row >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        if (col >= p.N) continue;  // N even: both columns or neither
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        float2* c = reinterpret_cast<float2*>(C + (size_t)row * p.ldc + col);
        if constexpr (EPI == EPI_F32 || EPI == EPI_PARTIAL) {
          if (p.bias != nullptr) v0 += p.bias[col], v1 += p.bias[col + 1];
          *c = make_float2(v0, v1);
        } else if constexpr (EPI == EPI_GELU_ERF || EPI == EPI_GELU_TANH) {
          if (p.bias != nullptr) v0 += p.bias[col], v1 += p.bias[col + 1];
          if (p.C2 != nullptr)
            *reinterpret_cast<float2*>(p.C2 + (size_t)row * p.ldc2 + col) = make_float2(v0, v1);
          *c = EPI == EPI_GELU_ERF ? make_float2(gelu_erf(v0), gelu_erf(v1))
                                   : make_float2(gelu_tanh(v0), gelu_tanh(v1));
        } else if constexpr (EPI == EPI_ADD_F32) {
          const float2 a = *reinterpret_cast<const float2*>(p.aux + (size_t)row * p.ld_aux + col);
          *c = make_float2(v0 + a.x, v1 + a.y);
        } else {  // EPI_DGELU_*
          const float2 u = *reinterpret_cast<const float2*>(p.aux + (size_t)row * p.ld_aux + col);
          v0 *= EPI == EPI_DGELU_ERF ? gelu_erf_grad(u.x) : gelu_tanh_grad(u.x);
          v1 *= EPI == EPI_DGELU_ERF ? gelu_erf_grad(u.y) : gelu_tanh_grad(u.y);
          *c = make_float2(v0, v1);
          if (p.C2 != nullptr)
            *reinterpret_cast<float2*>(p.C2 + (size_t)row * p.ldc2 + col) = make_float2(v0, v1);
          cs[nt][0] += v0;
          cs[nt][1] += v1;
        }
      }
    }

  if constexpr (EPI == EPI_DGELU_ERF || EPI == EPI_DGELU_TANH) {
    if (p.colpart == nullptr) return;
    // the warp's 64 rows over g (a fixed butterfly), then the tile's two
    // warps in order, through the spent stage buffers
    float* red = smem;  // [2][TILE_N]
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float v = cs[nt][c];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red[wm * TILE_N + wn * 32 + nt * 8 + 2 * t + c] = v;
      }
    __syncthreads();
    if (tid < TILE_N && n0 + tid < p.N)
      p.colpart[(size_t)blockIdx.y * p.N + n0 + tid] = red[tid] + red[TILE_N + tid];
  }
}

template <bool A_T, bool B_T, int EPI>
cudaError_t launch(const Params& p, int splits, cudaStream_t st) {
  auto* kernel = gemm_f32_kernel<A_T, B_T, EPI>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.N + TILE_N - 1) / TILE_N, (p.M + TILE_M - 1) / TILE_M, splits);
  kernel<<<grid, THREADS, SMEM_BYTES, st>>>(p);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

int round4(int n) { return (n + 3) / 4 * 4; }

}  // namespace

int run_gemm(int a_t, int b_t, const float* A, int lda, const float* B, int ldb, int M, int N,
             int K, int epi, int splits, int kchunk, float* C, int ldc, float* C2, int ldc2,
             const float* aux, int ld_aux, const float* bias, float* ws, float* colparts,
             float* colsum, cudaStream_t st) {
  // every 16-byte copy lies inside its row's leading dimension (past a row's
  // extent on to the next multiple of 4: zero pads, module comment)
  const int a_row = a_t ? M : K, b_row = b_t ? K : N;
  const bool shape_ok = M > 0 && N > 0 && K > 0 && round4(a_row) <= lda && round4(b_row) <= ldb &&
                        lda % 4 == 0 && ldb % 4 == 0 && N % 2 == 0 && ldc % 2 == 0 &&
                        aligned(A, 16) && aligned(B, 16) && aligned(C, 8);
  const bool dgelu = epi == EPI_DGELU_ERF || epi == EPI_DGELU_TANH;
  const bool epi_ok =
      a_t ? (!b_t && epi == EPI_F32 && ws != nullptr && bias == nullptr && splits >= 1 &&
             kchunk > 0 && kchunk % TILE_K == 0 && (long long)splits * kchunk >= K &&
             (long long)(splits - 1) * kchunk < K)
      : b_t ? (bias == nullptr && (epi == EPI_F32 || epi == EPI_ADD_F32 || dgelu))
            : (epi == EPI_F32 || epi == EPI_GELU_ERF || epi == EPI_GELU_TANH);
  const bool aux_ok = (epi == EPI_ADD_F32 || dgelu)
                          ? aux != nullptr && ld_aux % 2 == 0 && aligned(aux, 8)
                          : true;
  const bool c2_ok = C2 == nullptr || (ldc2 % 2 == 0 && aligned(C2, 8));
  const bool colsum_ok = colparts == nullptr ? colsum == nullptr : colsum != nullptr && dgelu;
  if (!shape_ok || !epi_ok || !aux_ok || !c2_ok || !colsum_ok) return cudaErrorInvalidValue;

  Params p{A, B, lda, ldb, M, N, K, K, C, ldc, C2, ldc2, aux, ld_aux, bias, colparts};
  cudaError_t e;
  if (a_t) {  // weight gradient: f32 partial products, then one fixed-order sum
    p.C = ws;
    p.ldc = N;
    p.kchunk = kchunk;
    e = launch<true, false, EPI_PARTIAL>(p, splits, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t total = (size_t)M * N;
    splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(ws, splits, M, N, C,
                                                                          ldc, 0);
    return static_cast<int>(cudaGetLastError());
  }
  if (b_t) {
    switch (epi) {
      case EPI_F32: e = launch<false, true, EPI_F32>(p, 1, st); break;
      case EPI_ADD_F32: e = launch<false, true, EPI_ADD_F32>(p, 1, st); break;
      case EPI_DGELU_ERF: e = launch<false, true, EPI_DGELU_ERF>(p, 1, st); break;
      default: e = launch<false, true, EPI_DGELU_TANH>(p, 1, st); break;
    }
  } else {
    switch (epi) {
      case EPI_F32: e = launch<false, false, EPI_F32>(p, 1, st); break;
      case EPI_GELU_ERF: e = launch<false, false, EPI_GELU_ERF>(p, 1, st); break;
      default: e = launch<false, false, EPI_GELU_TANH>(p, 1, st); break;
    }
  }
  if (e != cudaSuccess || colparts == nullptr) return static_cast<int>(e);
  return static_cast<int>(colparts_reduce(colparts, (M + TILE_M - 1) / TILE_M, N, colsum, st));
}

int run_ce(int epi, const float* x, const float* table, const float* bias, int rows, int vocab,
           int hidden, float* C, int ldc, const int* targets, const float* lse, const float* scale,
           float* part_f, int* part_i, cudaStream_t st) {
  const bool fwd = epi == EPI_CE_FWD;
  const bool ok = rows > 0 && vocab > 0 && hidden > 0 && hidden % 4 == 0 && aligned(x, 16) &&
                  aligned(table, 16) && bias != nullptr && targets != nullptr &&
                  part_f != nullptr && (fwd ? part_i != nullptr : epi == EPI_CE_BWD) &&
                  (fwd || (C != nullptr && lse != nullptr && scale != nullptr)) &&
                  (C == nullptr || (ldc >= vocab && ldc % 2 == 0 && aligned(C, 8)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, table, hidden, hidden, rows, vocab, hidden, hidden, C, ldc, nullptr, 0, nullptr, 0,
           bias, nullptr, targets, lse, scale, part_f, part_i};
  const cudaError_t e = fwd ? launch<false, true, EPI_CE_FWD>(p, 1, st)
                            : launch<false, true, EPI_CE_BWD>(p, 1, st);
  return static_cast<int>(e);
}

}  // namespace f32gemm
}  // namespace kvq

extern "C" {

// C (M, N) f32 = epi(op(A) @ op(B) [+ bias]) on f32 operands: a_t, A stored
// (K, M) (EPI_F32 only, through `splits` partials of kchunk rows of K in ws,
// (splits, M, N) f32); b_t, B stored (N, K); the epilogues and the rest as
// kvq::f32gemm::run_gemm. Returns a cudaError_t code.
int kvq_gemm_f32(int a_t, int b_t, const void* A, int lda, const void* B, int ldb, int M, int N,
                 int K, int epi, int splits, int kchunk, void* C, int ldc, void* C2, int ldc2,
                 const void* aux, int ld_aux, const void* bias, void* ws, void* colparts,
                 void* colsum, void* stream) {
  return kvq::f32gemm::run_gemm(
      a_t, b_t, static_cast<const float*>(A), lda, static_cast<const float*>(B), ldb, M, N, K,
      epi, splits, kchunk, static_cast<float*>(C), ldc, static_cast<float*>(C2), ldc2,
      static_cast<const float*>(aux), ld_aux, static_cast<const float*>(bias),
      static_cast<float*>(ws), static_cast<float*>(colparts), static_cast<float*>(colsum),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
