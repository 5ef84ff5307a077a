// Fused MLM-head vocab projection + cross-entropy + argmax for Hopper (sm_90a).
//
// Replaces kindergarten_vq_vae_tpu/ops/head_ce_pallas.py `_fwd_kernel` (l.67,
// TPU kernel #9) and `_bwd_kernel` (l.179, #10): for x (rows, H) bf16, the
// MLM transform's output, the tied word table E (V, H) bf16 and the head
// bias b (V,) f32,
//
//   forward   l = bf16(bf16(x @ E^T) + bf16(b))   (l.85: where the logits path
//             rounds its bf16 x @ W + b), nll[r] = logsumexp(l[r]) - l[r, t[r]],
//             lse[r], ids[r] = the first argmax of l[r]; store mode also writes
//             l (rows, V) bf16 for the backward, flash mode writes no logits
//   backward  gm = (exp(l - lse[r]) - [c == t[r]]) * scale[r] in f32, columns
//             past V masked, from the stored l (store) or from l recomputed by
//             the same code, to the same bits (flash, l.212-214); g = bf16(gm)
//             written with leading dimension ldg (V rounded up to 8, its pad
//             columns 0); dbias = the column sums of the f32 gm (l.224);
//             dx = g @ E in bf16
//
// What bounds it on the H100: operations. x @ E^T is 2 * rows * V * H =
// 1.15 TFLOP at 24,576 rows (1.17 ms at the bf16 tensor-core peak) against
// 1.6 GB of bytes (0.5 ms) in store mode; the backward's dx = g @ E is as
// large again, and flash mode adds the recompute. So the logits come from the
// port's wmma GEMM (layer_common.cuh `gemm_mainloop`, E read transposed in
// place: no transposed copy of the table, which JAX makes at l.335) and
// everything else is fused into its epilogue: a CTA computes one 128 x 128
// logits tile, rounds it into shared memory as bf16 and reduces it there.
// The TPU kernel carried its row accumulators across a sequential vocab grid
// in VMEM; blocks here run in no order, so the forward writes one partial
// (max, sum of exp, target logit, first argmax) per (vocab tile, row) and a
// second kernel merges each row's partials in vocab-tile order (the strict >
// of l.115 keeps the first maximum), and the backward's dbias takes one f32
// partial per (row tile, column), summed in a fixed order: the results do
// not depend on the order in which CTAs run. dx is a second launch of the
// wmma GEMM over the stored g, and the table's gradient g^T @ x (outside the
// TPU kernel, an XLA matmul with f32 output at l.365) a third, with f32 out.

#include "layer_common.cuh"

#include <cmath>

using namespace kvq;

namespace {

constexpr int LT_LD = BN + 8;                    // a logits-tile row in smem: 272 bytes
constexpr int LT_BYTES = BM * LT_LD * 2;         // the bf16 logits tile
constexpr int SCRATCH_BYTES = GEMM_THREADS / 32 * 256 * 4;  // per-warp f32 fragment scratch
constexpr int MAIN_BYTES = GemmTiles<false, true>::ELEMS * 2;
constexpr int HEAD_SMEM =
    MAIN_BYTES > LT_BYTES + SCRATCH_BYTES ? MAIN_BYTES : LT_BYTES + SCRATCH_BYTES;
static_assert(HEAD_SMEM <= 48 * 1024, "static shared memory");
static_assert(GEMM_THREADS == 2 * BM && GEMM_THREADS == 2 * BN, "two threads a row / column");

// One row's reduction over some columns: running max (also the argmax's
// value), sum of exp(l - m), target logit, and the first column holding m.
struct Part {
  float m, s, t;
  int i;
};

__device__ __forceinline__ void consume(Part& p, float x, int c, int tgt) {
  if (x > p.m) {  // strict: within a run of columns the first maximum stays
    p.s = p.s * expf(p.m - x) + 1.0f;
    p.m = x;
    p.i = c;
  } else {
    p.s += expf(x - p.m);
  }
  if (c == tgt) p.t = x;
}

// a <- a merged with b; equal maxima keep the lower column
__device__ __forceinline__ void merge(Part& a, const Part& b) {
  const float m = fmaxf(a.m, b.m);
  a.s = m == -INFINITY ? 0.0f : a.s * expf(a.m - m) + b.s * expf(b.m - m);
  if (b.m > a.m || (b.m == a.m && b.i < a.i)) a.i = b.i;
  a.m = m;
  a.t += b.t;
}

// The logits tile l[m0 : m0 + BM, n0 : n0 + BN] into smem as bf16 (BM x
// LT_LD); entries past rows or V hold bf16(b) or 0 and are masked by their
// readers. Ends with a barrier.
__device__ __forceinline__ void logits_tile(unsigned char* smem, const bf16* __restrict__ x,
                                            const bf16* __restrict__ E,
                                            const float* __restrict__ bias, int rows, int V, int H,
                                            int m0, int n0) {
  AccFrag acc[FM][FN];
  gemm_mainloop<false, true>(reinterpret_cast<bf16*>(smem), acc, x, H, E, H, rows, V, m0, n0, 0,
                             H);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  bf16* lt = reinterpret_cast<bf16*>(smem);
  float* cs = reinterpret_cast<float*>(smem + LT_BYTES) + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int q = lane; q < 256; q += 32) {
        const int r = wm * WM + i * 16 + q / 16, c = wn * WN + j * 16 + q % 16;
        const float b = n0 + c < V ? bf16_round(bias[n0 + c]) : 0.0f;
        lt[r * LT_LD + c] = __float2bfloat16(bf16_round(cs[q]) + b);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// #9: one CTA per (vocab tile blockIdx.x, row tile blockIdx.y). Partials
// (m, s, t, i) of row r and vocab tile j at [j * rows + r] of pf (3 planes
// of f32, plane stride plane) and pi.
template <bool STORE>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
head_ce_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ E,
                   const float* __restrict__ bias, const int* __restrict__ targets, int rows,
                   int V, int H, bf16* __restrict__ logits, float* __restrict__ pf, size_t plane,
                   int* __restrict__ pi) {
  __shared__ __align__(128) unsigned char smem[HEAD_SMEM];
  const int tid = threadIdx.x, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  logits_tile(smem, x, E, bias, rows, V, H, m0, n0);
  const bf16* lt = reinterpret_cast<const bf16*>(smem);
  if constexpr (STORE) {  // a warp writes 32 neighbouring columns of a row
    for (int e = tid; e < BM * BN; e += GEMM_THREADS) {
      const int r = e / BN, c = e % BN;
      if (m0 + r < rows && n0 + c < V) logits[(size_t)(m0 + r) * V + n0 + c] = lt[r * LT_LD + c];
    }
  }
  // thread tid reduces row tid % BM over columns [h * BN / 2, (h + 1) * BN / 2),
  // h = tid / BM, in column order: a warp reads 32 rows, 16 bytes each, with
  // no bank conflict (the row stride is 68 words)
  const int r = tid % BM, h = tid / BM, gr = m0 + r;
  const int tgt = gr < rows ? targets[gr] : -1;
  Part p{-INFINITY, 0.0f, 0.0f, 0};
  const int c0 = h * (BN / 2);
  for (int c8 = 0; c8 < BN / 2; c8 += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(lt + r * LT_LD + c0 + c8);
    const bf16* e8 = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int gc = n0 + c0 + c8 + k;
      if (gc < V) consume(p, __bfloat162float(e8[k]), gc, tgt);
    }
  }
  Part* upper = reinterpret_cast<Part*>(smem + LT_BYTES);  // the fragment scratch is free
  if (h == 1) upper[r] = p;
  __syncthreads();
  if (h == 0 && gr < rows) {
    merge(p, upper[r]);
    const size_t o = (size_t)blockIdx.x * rows + gr;
    pf[o] = p.m;
    pf[plane + o] = p.s;
    pf[2 * plane + o] = p.t;
    pi[o] = p.i;
  }
}

// #9's second pass: each row's partials merged in vocab-tile order.
__global__ void head_ce_merge_kernel(const float* __restrict__ pf, size_t plane,
                                     const int* __restrict__ pi, int ntiles, int rows,
                                     float* __restrict__ nll, float* __restrict__ lse,
                                     int* __restrict__ ids) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  Part a{-INFINITY, 0.0f, 0.0f, 0};
  for (int j = 0; j < ntiles; ++j) {
    const size_t o = (size_t)j * rows + r;
    merge(a, Part{pf[o], pf[plane + o], pf[2 * plane + o], pi[o]});
  }
  const float l = a.m + logf(a.s);
  lse[r] = l;
  nll[r] = l - a.t;
  ids[r] = a.i;
}

// #10's elementwise part: g and the dbias partial of one (vocab tile, row
// tile); dparts (row tiles, V) f32.
template <bool FLASH>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
head_ce_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ E,
                   const float* __restrict__ bias, const bf16* __restrict__ logits,
                   const int* __restrict__ targets, const float* __restrict__ lse,
                   const float* __restrict__ scale, int rows, int V, int H, bf16* __restrict__ g,
                   int ldg, float* __restrict__ dparts) {
  __shared__ __align__(128) unsigned char smem[HEAD_SMEM];
  const int tid = threadIdx.x, m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  bf16* lt = reinterpret_cast<bf16*>(smem);
  if constexpr (FLASH) {
    logits_tile(smem, x, E, bias, rows, V, H, m0, n0);
  } else {
    for (int e = tid; e < BM * BN; e += GEMM_THREADS) {
      const int r = e / BN, c = e % BN;
      lt[r * LT_LD + c] = m0 + r < rows && n0 + c < V ? logits[(size_t)(m0 + r) * V + n0 + c]
                                                      : __float2bfloat16(0.0f);
    }
  }
  float* rl = reinterpret_cast<float*>(smem + LT_BYTES);  // per row: lse, scale, target
  float* rs = rl + BM;
  int* rt = reinterpret_cast<int*>(rs + BM);
  float* colp = reinterpret_cast<float*>(rt + BM);  // (2, BN) column partials
  if (tid < BM) {
    const int gr = m0 + tid;
    rl[tid] = gr < rows ? lse[gr] : 0.0f;
    rs[tid] = gr < rows ? scale[gr] : 0.0f;
    rt[tid] = gr < rows ? targets[gr] : -1;
  }
  __syncthreads();
  // thread tid: column tid % BN, rows [h * BM / 2, (h + 1) * BM / 2), h = tid / BN
  const int c = tid % BN, h = tid / BN, gc = n0 + c;
  const int rend = min(BM / 2 * (h + 1), rows - m0);
  float sum = 0.0f;
  for (int r = BM / 2 * h; r < rend; ++r) {
    bf16* out = g + (size_t)(m0 + r) * ldg + gc;
    if (gc < V) {
      const float l = __bfloat162float(lt[r * LT_LD + c]);
      const float gm = (expf(l - rl[r]) - (gc == rt[r] ? 1.0f : 0.0f)) * rs[r];
      sum += gm;
      *out = __float2bfloat16(gm);
    } else if (gc < ldg) {
      *out = __float2bfloat16(0.0f);
    }
  }
  colp[h * BN + c] = sum;
  __syncthreads();
  if (h == 0 && gc < V) dparts[(size_t)blockIdx.y * V + gc] = colp[c] + colp[BN + c];
}

inline int vocab_tiles(int V) { return (V + BN - 1) / BN; }
inline int row_tiles(int rows) { return (rows + BM - 1) / BM; }

}  // namespace

extern "C" {

// #9. x (rows, hidden) bf16, table (vocab, hidden) bf16, bias (vocab,) f32,
// targets (rows,) int32, all row-major; hidden a multiple of 8, x and table
// 16-byte aligned. logits (rows, vocab) bf16 is written when not null (store
// mode). parts_f32 (3, ceil(vocab / 128), rows) and parts_i32
// (ceil(vocab / 128), rows) scratch; nll, lse (rows,) f32 and ids (rows,)
// int32 written.
int kvq_head_ce_fwd(const void* x, const void* table, const void* bias, const int* targets,
                    int rows, int vocab, int hidden, void* logits, void* parts_f32,
                    void* parts_i32, void* nll, void* lse, void* ids, void* stream) {
  if (rows <= 0) return 0;
  if (hidden % 8 != 0 || vocab <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = vocab_tiles(vocab);
  const size_t plane = (size_t)nv * rows;
  const dim3 grid(nv, row_tiles(rows));
  const bf16 *xb = static_cast<const bf16*>(x), *eb = static_cast<const bf16*>(table);
  const float* b = static_cast<const float*>(bias);
  float* pf = static_cast<float*>(parts_f32);
  int* pi = static_cast<int*>(parts_i32);
  if (logits != nullptr)
    head_ce_fwd_kernel<true><<<grid, GEMM_THREADS, 0, st>>>(
        xb, eb, b, targets, rows, vocab, hidden, static_cast<bf16*>(logits), pf, plane, pi);
  else
    head_ce_fwd_kernel<false><<<grid, GEMM_THREADS, 0, st>>>(
        xb, eb, b, targets, rows, vocab, hidden, nullptr, pf, plane, pi);
  head_ce_merge_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      pf, plane, pi, nv, rows, static_cast<float*>(nll), static_cast<float*>(lse),
      static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

// #10. Store mode reads logits (rows, vocab) bf16; flash mode (logits null)
// recomputes them from x, table and bias as kvq_head_ce_fwd does. lse, scale
// (rows,) f32. Writes g (rows, ldg) bf16 (ldg a multiple of 8, >= vocab; pad
// columns 0), dbias (vocab,) f32 through dparts (ceil(rows / 128), vocab) f32
// scratch, and dx = g @ table (rows, hidden) bf16.
int kvq_head_ce_bwd(const void* x, const void* table, const void* bias, const void* logits,
                    const int* targets, const void* lse, const void* scale, int rows, int vocab,
                    int hidden, void* g, int ldg, void* dparts, void* dbias, void* dx,
                    void* stream) {
  if (rows <= 0) return 0;
  if (hidden % 8 != 0 || ldg % 8 != 0 || ldg < vocab || vocab <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nr = row_tiles(rows);
  const dim3 grid(vocab_tiles(vocab), nr);
  const bf16 *xb = static_cast<const bf16*>(x), *eb = static_cast<const bf16*>(table);
  const float *b = static_cast<const float*>(bias), *l = static_cast<const float*>(lse),
              *sc = static_cast<const float*>(scale);
  bf16* gb = static_cast<bf16*>(g);
  float* dp = static_cast<float*>(dparts);
  if (logits == nullptr)
    head_ce_bwd_kernel<true><<<grid, GEMM_THREADS, 0, st>>>(
        xb, eb, b, nullptr, targets, l, sc, rows, vocab, hidden, gb, ldg, dp);
  else
    head_ce_bwd_kernel<false><<<grid, GEMM_THREADS, 0, st>>>(
        nullptr, eb, b, static_cast<const bf16*>(logits), targets, l, sc, rows, vocab, hidden,
        gb, ldg, dp);
  splitk_reduce_kernel<<<(vocab + 255) / 256, 256, 0, st>>>(dp, nr, 1, vocab, dbias, vocab, 0);
  const GemmEpi e{dx, hidden, nullptr, 0, nullptr, 0, EPI_BF16};
  launch_gemm<false, false, EPI_BF16>(g, ldg, table, hidden, e, rows, hidden, vocab, vocab, 1, st);
  return static_cast<int>(cudaGetLastError());
}

// The table's gradient out (vocab, hidden) f32 = g^T @ x, g (rows, ldg) bf16
// as kvq_head_ce_bwd writes it, x (rows, hidden) bf16.
int kvq_head_ce_dtable(const void* g, int ldg, const void* x, int rows, int vocab, int hidden,
                       void* out, void* stream) {
  if (hidden % 8 != 0 || ldg % 8 != 0 || ldg < vocab || vocab <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmEpi e{out, hidden, nullptr, 0, nullptr, 0, EPI_F32};
  launch_gemm<true, false, EPI_F32>(g, ldg, x, hidden, e, vocab, hidden, rows, rows, 1,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
