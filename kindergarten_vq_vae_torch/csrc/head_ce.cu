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
//             l (rows, ldl) bf16 for the backward (ldl = V rounded up to 8, its
//             pad columns 0), flash mode writes no logits
//   backward  gm = (exp(l - lse[r]) - [c == t[r]]) * scale[r] in f32, columns
//             past V masked, from the stored l (store) or from l recomputed by
//             the same code, to the same bits (flash, l.212-214); g = bf16(gm)
//             written with leading dimension ldg (V rounded up to 8, its pad
//             columns 0); dbias = the column sums of the f32 gm (l.224);
//             dx = g @ E in bf16
//
// and the table's gradient g^T @ x in f32 (outside the TPU kernel: an XLA
// matmul with f32 output, l.365-367).
//
// What bounds it on the H100: operations. x @ E^T is 2 * rows * V * H =
// 1.15 TFLOP at 24,576 rows (1.17 ms at the bf16 tensor-core peak) against
// 1.6 GB of bytes (0.5 ms) in store mode; dx = g @ E and g^T @ x are as large
// again, and flash mode adds the recompute. So every product runs on the
// wgmma + TMA GEMM of gemm_sm90.cuh (E read transposed in place through the
// descriptors: no transposed copy of the table, which JAX makes at l.335),
// and the CE work rides in its staged epilogue: the consumers drop each
// 128 x 128 f32 tile into shared memory and go on to the next tile's
// products while two epilogue warpgroups round it to the logits and reduce
// it (ce_tile below). The TPU kernel carried its row accumulators across a
// sequential vocab grid in VMEM; tiles here finish in no order, so the
// forward writes one partial (max, sum of exp, target logit, first argmax)
// per (vocab tile, row), which a second kernel merges in vocab-tile order
// (the strict > of l.115 keeps the first maximum), and the backward writes
// one f32 dbias partial per (row tile, column), each a sum over the tile's
// rows in row order, summed in a fixed order: the results do not depend on
// the order in which tiles run. Store mode's backward reads the stored logits
// in a memory-bound pass with 16-byte loads and stores that sums in the same
// order, so both modes give the same bits. dx is the GEMM's NN product over
// g (K = V, its ragged tail read as zeros), the table gradient its TN split-K
// product.
//
// In f32 (JAX's parity dtype: x, the table, the logits and g f32, l = x @ E^T
// + b with no rounding between the product and the CE) the same functions
// run on the f32 GEMM (gemm_f32.cu, 3xTF32 on wgmma): #9 and #10's flash
// recompute as its NT product with a CE epilogue (run_ce), whose partials
// head_ce_merge_kernel merges as above; store mode's pass over the f32
// logits is head_ce_grad_f32_kernel, which sums dbias in the f32 epilogue's
// order, so flash equals store to the bit here too; dx = g @ E and the table
// gradient are the f32 GEMM's NN and TN split-K products (run_gemm) over g's
// padded rows (kvq_head_ce_*_f32 below).

#include <climits>
#include <cmath>

#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"

namespace kvq {
namespace sm90 {

// The CE epilogues' tile width, pinned: #9 and #10's flash recompute must
// see the same tiles and K order to give the same logits.
constexpr int HEAD_TILE_N = 128;
constexpr int HEAD_WARPS = 4 * Cfg<HEAD_TILE_N, EPI_CE_FWD>::EPI_WGS;  // epilogue warps
static_assert(HEAD_WARPS == 8 && Cfg<HEAD_TILE_N, EPI_CE_BWD>::EPI_WGS == 2, "8 epilogue warps");
// The epilogues' lanes: a warp takes GROUP_ROWS rows a step, ROW_LANES lanes
// a row; lane k of a row holds its columns 64 i + 8 k + j (i < CHUNKS, j <
// 8), in increasing order of (i, j), read as 16-byte chunks of the bf16
// staging tile. Each lane reduces 16 columns alone, so a row costs three
// shuffle steps per reduction and every lane has 16 independent elements in
// flight.
constexpr int ROW_LANES = 8, GROUP_ROWS = 32 / ROW_LANES;
constexpr int CHUNKS = HEAD_TILE_N / (8 * ROW_LANES);
constexpr int STEPS = TILE_M / (GROUP_ROWS * HEAD_WARPS);  // steps a warp takes a tile
static_assert(CHUNKS == 2 && STEPS * GROUP_ROWS <= 32, "a lane holds one row's operands");

// the tile row of warp w's row group_row in step `step` (both #10 kernels
// follow it, so they sum dbias in one order)
__device__ __forceinline__ int tile_row(int w, int step, int group_row) {
  return GROUP_ROWS * (w + HEAD_WARPS * step) + group_row;
}

// The logits of a chunk: bf16(bf16(acc) + bf16(b)) from the staged bf16(acc)
// (add.bf16x2 rounds the exact sum once, as f32 then bf16 would: two bf16
// values sum exactly in f32 unless their exponents lie 16 or more apart, and
// then both give the larger), in f32, columns at or past V at -inf.
__device__ __forceinline__ void chunk_logits(const uint4& raw, const __nv_bfloat162 (&b2)[4],
                                             int col, int V, float (&l)[8]) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float2 v = __bfloat1622float2(__hadd2(a[jj], b2[jj]));
    l[2 * jj] = col + 2 * jj < V ? v.x : -INFINITY;
    l[2 * jj + 1] = col + 2 * jj + 1 < V ? v.y : -INFINITY;
  }
}

// reductions over a row's ROW_LANES lanes (butterflies: every lane of the
// row ends with the same bits)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = ROW_LANES / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = ROW_LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int row_min(int v) {
#pragma unroll
  for (int o = ROW_LANES / 2; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// eight bf16 (16 bytes) from eight floats
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * jj], v[2 * jj + 1]);
    w[jj] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The staged CE epilogue (gemm_sm90.cuh), lanes and rows as above.
// EPI_CE_FWD: p.C the bf16 logits (row stride p.ldc, pad columns written 0)
// or null; writes the tile's partials at [n0 / BN, row] of p.ce.part_f (3
// planes of tiles_n x M) and p.ce.part_i. EPI_CE_BWD: p.C = g (row stride
// p.ldc, pad columns 0), and into [m0 / TILE_M, n0 + c] of p.ce.part_f (row
// tiles x N) the sum of column c over the tile's rows, in the order
// head_ce_grad_kernel sums in: each lane over its rows in step order, the
// four lanes of a column in a butterfly, then the warps in order.
template <int EPI, int BN, int WARPS>
__device__ void ce_tile(const Args& p, bf16* stg, int ld, int m0, int n0, int ew, int lane,
                        uint32_t full, uint32_t parity) {
  static_assert(BN == HEAD_TILE_N && WARPS == HEAD_WARPS, "the pinned CE tile");
  const int rows = p.M, V = p.N;
  const int rr = lane / ROW_LANES, k = lane % ROW_LANES;
  // the per-row operands of this warp's rows: lane GROUP_ROWS s + rr holds
  // those of step s's row rr
  const int my_row = m0 + tile_row(ew, lane / GROUP_ROWS, lane % GROUP_ROWS);
  const bool lane_row = lane < STEPS * GROUP_ROWS && my_row < rows;
  const int tgt_l = lane_row ? p.ce.targets[my_row] : -1;
  float lse_l = 0.0f, scale_l = 0.0f;
  if constexpr (EPI == EPI_CE_BWD) {
    lse_l = lane_row ? p.ce.lse[my_row] : 0.0f;
    scale_l = lane_row ? p.ce.scale[my_row] : 0.0f;
  }
  __nv_bfloat162 b2[CHUNKS][4];  // bf16(b) of this lane's columns
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + 64 * i + 8 * k + 2 * jj;
      b2[i][jj] = __floats2bfloat162_rn(col < V ? p.bias[col] : 0.0f,
                                        col + 1 < V ? p.bias[col + 1] : 0.0f);
    }
  mbar_wait(full, parity);

  bf16* out = static_cast<bf16*>(p.C);
  float cs[CHUNKS][8] = {};  // EPI_CE_BWD: this lane's column sums over its rows
#pragma unroll 1
  for (int step = 0; step < STEPS; ++step) {
    const int r = tile_row(ew, step, rr), row = m0 + r;
    const bool live = row < rows;
    const int src = GROUP_ROWS * step + rr;
    const int tgt = __shfl_sync(0xffffffffu, tgt_l, src);
    float l[CHUNKS][8];
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i)
      chunk_logits(*reinterpret_cast<const uint4*>(stg + r * ld + 64 * i + 8 * k), b2[i],
                   n0 + 64 * i + 8 * k, V, l[i]);
    if constexpr (EPI == EPI_CE_FWD) {
      float m8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) m8[j] = fmaxf(l[0][j], l[1][j]);
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) m8[j] = fmaxf(m8[j], m8[j + w]);
      const float mx = row_max(m8[0]);
      float e[CHUNKS][8];
      int first = INT_MAX;
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          e[i][j] = expf(__fsub_rn(l[i][j], mx));  // 0 at the masked columns' -inf
          if (l[i][j] == mx) first = min(first, n0 + 64 * i + 8 * k + j);
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) e[0][j] += e[1][j];
#pragma unroll
      for (int w = 4; w > 0; w >>= 1)
#pragma unroll
        for (int j = 0; j < w; ++j) e[0][j] += e[0][j + w];
      const float sum = row_sum(e[0][0]);
      first = row_min(first);
      if (live && out != nullptr) {
#pragma unroll
        for (int i = 0; i < CHUNKS; ++i) {
          const int col = n0 + 64 * i + 8 * k;
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = col + j < V ? l[i][j] : 0.0f;
          if (col < p.ldc)  // 8 columns: all inside (p.ldc % 8 == 0); past V 0
            *reinterpret_cast<uint4*>(out + (size_t)row * p.ldc + col) = pack8(v);
        }
      }
      if (live && k == 0) {
        float t = 0.0f;  // the target logit, where the target is in this tile
        if (tgt >= n0 && tgt < n0 + BN && tgt < V)
          t = __bfloat162float(__hadd(stg[r * ld + tgt - n0], __float2bfloat16(p.bias[tgt])));
        const size_t plane = (size_t)p.tiles_n * rows, o = (size_t)(n0 / BN) * rows + row;
        p.ce.part_f[o] = mx;
        p.ce.part_f[plane + o] = sum;
        p.ce.part_f[2 * plane + o] = t;
        p.ce.part_i[o] = first;
      }
    } else {
      static_assert(EPI == EPI_CE_BWD, "the CE epilogues");
      const float lse = __shfl_sync(0xffffffffu, lse_l, src);
      const float scale = __shfl_sync(0xffffffffu, scale_l, src);
      if (live) {
#pragma unroll
        for (int i = 0; i < CHUNKS; ++i) {
          const int col = n0 + 64 * i + 8 * k;
          float gm[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            gm[j] = col + j < V ? ce_grad(l[i][j], lse, col + j == tgt, scale) : 0.0f;
            cs[i][j] += gm[j];
          }
          if (col < p.ldc)
            *reinterpret_cast<uint4*>(out + (size_t)row * p.ldc + col) = pack8(gm);
        }
      }
    }
  }
  if constexpr (EPI == EPI_CE_BWD) {
    // the four lanes of a column (rr), then the warps in order, each warp's
    // sums parked in its own step-0 rows of the tile, which it has read
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cs[i][j] += __shfl_xor_sync(0xffffffffu, cs[i][j], ROW_LANES);
        cs[i][j] += __shfl_xor_sync(0xffffffffu, cs[i][j], 2 * ROW_LANES);
      }
    float* part = reinterpret_cast<float*>(stg + GROUP_ROWS * ew * ld);
    if (rr == 0)
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
        for (int j = 0; j < 8; j += 4)
          *reinterpret_cast<float4*>(part + 64 * i + 8 * k + j) =
              make_float4(cs[i][j], cs[i][j + 1], cs[i][j + 2], cs[i][j + 3]);
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
    const int c = 32 * ew + lane;
    if (c < BN && n0 + c < V) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        sum += reinterpret_cast<const float*>(stg + GROUP_ROWS * w * ld)[c];
      p.ce.part_f[(size_t)(m0 / TILE_M) * V + n0 + c] = sum;
    }
  }
}

namespace {

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

constexpr int GRAD_COLS = 256;  // columns of one block of the store-mode pass: 8 a lane

// #10 in store mode: g and the dbias partials from the stored logits (row
// stride ldl, a multiple of 8), one block of HEAD_WARPS warps per (256
// columns, 128 rows), 16 bytes a lane a row. Warp w takes the rows the flash
// epilogue's warp w takes and sums each column over them in its order, and
// the block adds the warps' sums in warp order, so both modes give the same
// bits.
__global__ void __launch_bounds__(32 * HEAD_WARPS)
head_ce_grad_kernel(const bf16* __restrict__ logits, int ldl, const int* __restrict__ targets,
                    const float* __restrict__ lse, const float* __restrict__ scale, int rows,
                    int V, bf16* __restrict__ g, int ldg, float* __restrict__ dparts) {
  __shared__ float colp[HEAD_WARPS][GRAD_COLS];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * TILE_M, c0 = blockIdx.x * GRAD_COLS + 8 * lane;
  const int my_row = m0 + tile_row(w, lane / GROUP_ROWS, lane % GROUP_ROWS);
  const bool lane_row = lane < STEPS * GROUP_ROWS && my_row < rows;
  const int tgt_l = lane_row ? targets[my_row] : -1;
  const float lse_l = lane_row ? lse[my_row] : 0.0f, scale_l = lane_row ? scale[my_row] : 0.0f;
  float s[GROUP_ROWS][8] = {};
#pragma unroll
  for (int step = 0; step < STEPS; ++step)
#pragma unroll
    for (int rr = 0; rr < GROUP_ROWS; ++rr) {
      const int src = GROUP_ROWS * step + rr, row = m0 + tile_row(w, step, rr);
      const int tgt = __shfl_sync(0xffffffffu, tgt_l, src);
      const float l_se = __shfl_sync(0xffffffffu, lse_l, src);
      const float sc = __shfl_sync(0xffffffffu, scale_l, src);
      if (row >= rows || c0 >= ldg) continue;
      uint4 in = make_uint4(0, 0, 0, 0);
      if (c0 < V) in = *reinterpret_cast<const uint4*>(logits + (size_t)row * ldl + c0);
      const bf16* l8 = reinterpret_cast<const bf16*>(&in);
      float gm[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        gm[k] = c0 + k < V ? ce_grad(__bfloat162float(l8[k]), l_se, c0 + k == tgt, sc) : 0.0f;
        s[rr][k] += gm[k];
      }
      *reinterpret_cast<uint4*>(g + (size_t)row * ldg + c0) = pack8(gm);
    }
#pragma unroll
  for (int k = 0; k < 8; ++k) colp[w][8 * lane + k] = (s[0][k] + s[1][k]) + (s[2][k] + s[3][k]);
  __syncthreads();
  const int col = blockIdx.x * GRAD_COLS + threadIdx.x;
  if (threadIdx.x < GRAD_COLS && col < V) {
    float tot = 0.0f;
#pragma unroll
    for (int k = 0; k < HEAD_WARPS; ++k) tot += colp[k][threadIdx.x];
    dparts[(size_t)blockIdx.y * V + col] = tot;
  }
}

// the f32 store-mode pass: a block a (128-row tile, GRAD_F32_COLS columns),
// 4 columns (16 bytes) a thread
constexpr int GRAD_F32_THREADS = 128, GRAD_F32_COLS = 4 * GRAD_F32_THREADS;

// ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7)): the sum of the f32 CE
// epilogue's xor-butterfly over a warp's eight row groups, as lane g = 0 holds it
__device__ __forceinline__ float butterfly8(const float (&s)[8]) {
  return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

// #10 in store mode on f32 logits (row stride ldl, a multiple of 8): g (row
// stride ldg, pad columns 0) and the dbias partials. A column's sum over the
// tile's rows follows the f32 flash epilogue (gemm_f32.cu tile_column_sums)
// to the bit: tile row r = 16 w + 8 h + g (w the epilogue's warp, 0..7) is
// added to the sum of (w, g) in h order, the eight sums of a w combine as
// its butterfly does, and the warps' sums are added in w order.
__global__ void __launch_bounds__(GRAD_F32_THREADS)
head_ce_grad_f32_kernel(const float* __restrict__ logits, int ldl, const int* __restrict__ targets,
                        const float* __restrict__ lse, const float* __restrict__ scale, int rows,
                        int V, float* __restrict__ g, int ldg, float* __restrict__ dparts) {
  __shared__ int s_tgt[TILE_M];
  __shared__ float s_lse[TILE_M], s_sc[TILE_M];
  const int m0 = blockIdx.y * TILE_M, c0 = blockIdx.x * GRAD_F32_COLS + 4 * threadIdx.x;
  for (int r = threadIdx.x; r < TILE_M; r += GRAD_F32_THREADS) {
    const bool live = m0 + r < rows;
    s_tgt[r] = live ? targets[m0 + r] : -1;
    s_lse[r] = live ? lse[m0 + r] : 0.0f;
    s_sc[r] = live ? scale[m0 + r] : 0.0f;
  }
  __syncthreads();
  if (c0 >= ldg) return;
  float tot[4] = {};
  for (int w = 0; w < TILE_M / 16; ++w) {
    float s[8][4] = {};  // (g, column)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int gg = 0; gg < 8; ++gg) {
        const int r = 16 * w + 8 * h + gg, row = m0 + r;
        if (row >= rows) continue;
        float4 in = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (c0 < V) in = *reinterpret_cast<const float4*>(logits + (size_t)row * ldl + c0);
        const float l4[4] = {in.x, in.y, in.z, in.w};
        float gm[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          gm[k] = c0 + k < V ? ce_grad(l4[k], s_lse[r], c0 + k == s_tgt[r], s_sc[r]) : 0.0f;
          s[gg][k] += gm[k];
        }
        *reinterpret_cast<float4*>(g + (size_t)row * ldg + c0) =
            make_float4(gm[0], gm[1], gm[2], gm[3]);
      }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float sk[8];
#pragma unroll
      for (int gg = 0; gg < 8; ++gg) sk[gg] = s[gg][k];
      const float b = butterfly8(sk);
      tot[k] = w == 0 ? b : tot[k] + b;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (c0 + k >= V) break;
    dparts[(size_t)blockIdx.y * V + c0 + k] = tot[k];
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int row_tiles(int rows) { return (rows + TILE_M - 1) / TILE_M; }
int vocab_tiles(int V) { return (V + HEAD_TILE_N - 1) / HEAD_TILE_N; }

// the NT product x (rows, H) @ E^T with a CE epilogue: p's maps and sizes
bool ce_product(Args& p, CUtensorMap* ma, CUtensorMap* mb, const void* x, const void* table,
                int rows, int vocab, int hidden) {
  p.M = rows;
  p.N = vocab;
  p.K = hidden;
  p.kchunk = (hidden + TILE_K - 1) / TILE_K * TILE_K;
  p.splits = 1;
  p.tiles_m = row_tiles(rows);
  p.tiles_n = vocab_tiles(vocab);
  return aligned16(x) && aligned16(table) &&
         tensor_map(ma, x, rows, hidden, hidden, 64, TILE_M) &&
         tensor_map(mb, table, vocab, hidden, hidden, 64, HEAD_TILE_N);
}

}  // namespace
}  // namespace sm90
}  // namespace kvq

using namespace kvq;
using namespace kvq::sm90;

extern "C" {

// #9. x (rows, hidden) bf16, table (vocab, hidden) bf16, bias (vocab,) f32,
// targets (rows,) int32, all row-major; hidden a multiple of 8, x and table
// 16-byte aligned; tile_n the pinned CE tile width (128). logits (rows, ldl)
// bf16 (ldl a multiple of 8, >= vocab; pad columns written 0) when not null
// (store mode). parts_f32 (3, ceil(vocab / tile_n), rows) and parts_i32
// (ceil(vocab / tile_n), rows) scratch; nll, lse (rows,) f32 and ids (rows,)
// int32 written. sms caps the persistent grid.
int kvq_head_ce_fwd(const void* x, const void* table, const void* bias, const int* targets,
                    int rows, int vocab, int hidden, void* logits, int ldl, int tile_n,
                    void* parts_f32, void* parts_i32, void* nll, void* lse, void* ids, int sms,
                    void* stream) {
  if (rows <= 0) return 0;
  if (hidden % 8 != 0 || vocab <= 0 || tile_n != HEAD_TILE_N || sms <= 0 ||
      (logits != nullptr && (ldl % 8 != 0 || ldl < vocab || !aligned16(logits))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args p{};
  CUtensorMap ma, mb;
  if (!ce_product(p, &ma, &mb, x, table, rows, vocab, hidden))
    return static_cast<int>(cudaErrorInvalidValue);
  p.C = logits;
  p.ldc = ldl;
  p.bias = static_cast<const float*>(bias);
  p.ce.targets = targets;
  p.ce.part_f = static_cast<float*>(parts_f32);
  p.ce.part_i = static_cast<int*>(parts_i32);
  cudaError_t e = launch<HEAD_TILE_N, false, false, EPI_CE_FWD>(ma, mb, p, sms, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  head_ce_merge_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      p.ce.part_f, (size_t)p.tiles_n * rows, p.ce.part_i, p.tiles_n, rows,
      static_cast<float*>(nll), static_cast<float*>(lse), static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

// #10. Store mode reads logits (rows, vocab) bf16 with row stride ldl (a
// multiple of 8, 16-byte aligned); flash mode (logits null) recomputes them
// from x, table and bias as kvq_head_ce_fwd does (tile_n the same 128). lse,
// scale (rows,) f32. Writes g (rows, ldg) bf16 (ldg a multiple of 8, >=
// vocab; pad columns 0), dbias (vocab,) f32 through dparts (ceil(rows / 128),
// vocab) f32 scratch, and dx = g @ table (rows, hidden) bf16 on the GEMM's NN
// product with tile width dx_tile_n and K chunk dx_kchunk (ops/gemm.py
// `gemm_plan`).
int kvq_head_ce_bwd(const void* x, const void* table, const void* bias, const void* logits,
                    int ldl, const int* targets, const void* lse, const void* scale, int rows,
                    int vocab, int hidden, int tile_n, void* g, int ldg, void* dparts, void* dbias,
                    void* dx, int dx_tile_n, int dx_kchunk, int sms, void* stream) {
  if (rows <= 0) return 0;
  if (hidden % 8 != 0 || ldg % 8 != 0 || ldg < vocab || vocab <= 0 || tile_n != HEAD_TILE_N ||
      sms <= 0 || !aligned16(g) ||
      (logits != nullptr && (ldl % 8 != 0 || ldl < vocab || !aligned16(logits))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nr = row_tiles(rows);
  const int* tg = targets;
  const float *l = static_cast<const float*>(lse), *sc = static_cast<const float*>(scale);
  float* dp = static_cast<float*>(dparts);
  if (logits == nullptr) {
    Args p{};
    CUtensorMap ma, mb;
    if (!ce_product(p, &ma, &mb, x, table, rows, vocab, hidden))
      return static_cast<int>(cudaErrorInvalidValue);
    p.C = g;
    p.ldc = ldg;
    p.bias = static_cast<const float*>(bias);
    p.ce = CeArgs{tg, l, sc, dp, nullptr};
    const cudaError_t e = launch<HEAD_TILE_N, false, false, EPI_CE_BWD>(ma, mb, p, sms, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    const dim3 grid((ldg + GRAD_COLS - 1) / GRAD_COLS, nr);
    head_ce_grad_kernel<<<grid, 32 * HEAD_WARPS, 0, st>>>(static_cast<const bf16*>(logits), ldl,
                                                           tg, l, sc, rows, vocab,
                                                           static_cast<bf16*>(g), ldg, dp);
  }
  splitk_reduce_kernel<<<(vocab + 255) / 256, 256, 0, st>>>(dp, nr, 1, vocab, dbias, vocab, 0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return run_gemm(0, 1, g, ldg, table, hidden, rows, hidden, vocab, EPI_BF16, dx_tile_n, 1,
                  dx_kchunk, dx, hidden, nullptr, 0, nullptr, 0, nullptr, nullptr, sms, st);
}

// The table's gradient out (vocab, hidden) f32 = g^T @ x, g (rows, ldg) bf16
// as kvq_head_ce_bwd writes it, x (rows, hidden) bf16: the GEMM's TN product
// in `splits` chunks of kchunk rows (tile width tile_n; ops/gemm.py
// `gemm_plan`) whose f32 partials in ws (splits, vocab, hidden) are summed in
// a fixed order.
int kvq_head_ce_dtable(const void* g, int ldg, const void* x, int rows, int vocab, int hidden,
                       void* out, int tile_n, int splits, int kchunk, void* ws, int sms,
                       void* stream) {
  if (ldg < vocab) return static_cast<int>(cudaErrorInvalidValue);
  return run_gemm(1, 1, g, ldg, x, hidden, vocab, hidden, rows, EPI_F32, tile_n, splits, kchunk,
                  out, hidden, nullptr, 0, nullptr, 0, nullptr, static_cast<float*>(ws), sms,
                  static_cast<cudaStream_t>(stream));
}

// #9 in f32: x (rows, hidden), table (vocab, hidden), bias (vocab,) f32,
// targets (rows,) int32; hidden a multiple of 4, x and table 16-byte
// aligned; any vocab. logits (rows, ldl) f32 (ldl a multiple of 8, >=
// vocab; pad columns written 0) when not null (store mode); parts_f32 (3,
// ceil(vocab / 128), rows) and parts_i32 (ceil(vocab / 128), rows) scratch;
// nll, lse (rows,) f32 and ids (rows,) int32 written.
int kvq_head_ce_fwd_f32(const void* x, const void* table, const void* bias, const int* targets,
                        int rows, int vocab, int hidden, void* logits, int ldl, void* parts_f32,
                        void* parts_i32, void* nll, void* lse, void* ids, void* stream) {
  if (rows <= 0) return 0;
  if (vocab <= 0 || (logits != nullptr && (ldl % 8 != 0 || ldl < vocab || !aligned16(logits))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(parts_f32);
  int* pi = static_cast<int*>(parts_i32);
  const int e = f32gemm::run_ce(EPI_CE_FWD, static_cast<const float*>(x),
                                static_cast<const float*>(table), static_cast<const float*>(bias),
                                rows, vocab, hidden, static_cast<float*>(logits), ldl, targets,
                                nullptr, nullptr, pf, pi, st);
  if (e != 0) return e;
  const int tiles = vocab_tiles(vocab);
  head_ce_merge_kernel<<<(rows + 255) / 256, 256, 0, st>>>(
      pf, (size_t)tiles * rows, pi, tiles, rows, static_cast<float*>(nll),
      static_cast<float*>(lse), static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

// #10 in f32. Store mode reads logits (rows, vocab) f32 with row stride ldl
// (a multiple of 8, 16-byte aligned, pad columns 0); flash mode (logits
// null) recomputes them from x, table and bias as kvq_head_ce_fwd_f32 does.
// lse, scale (rows,) f32. Writes g (rows, ldg) f32 (ldg a multiple of 8, >=
// vocab; pad columns 0), dbias (vocab,) f32 through dparts (ceil(rows / 128),
// vocab) f32 scratch, and dx = g @ table (rows, hidden) f32 on the f32 GEMM's
// NN product (K = vocab, g's rows read up to ldg).
int kvq_head_ce_bwd_f32(const void* x, const void* table, const void* bias, const void* logits,
                        int ldl, const int* targets, const void* lse, const void* scale, int rows,
                        int vocab, int hidden, void* g, int ldg, void* dparts, void* dbias,
                        void* dx, void* stream) {
  if (rows <= 0) return 0;
  if (ldg % 8 != 0 || ldg < vocab || vocab <= 0 || !aligned16(g) ||
      (logits != nullptr && (ldl % 8 != 0 || ldl < vocab || !aligned16(logits))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nr = row_tiles(rows);
  const float *l = static_cast<const float*>(lse), *sc = static_cast<const float*>(scale);
  float* dp = static_cast<float*>(dparts);
  float* gf = static_cast<float*>(g);
  if (logits == nullptr) {
    const int e = f32gemm::run_ce(EPI_CE_BWD, static_cast<const float*>(x),
                                  static_cast<const float*>(table),
                                  static_cast<const float*>(bias), rows, vocab, hidden, gf, ldg,
                                  targets, l, sc, dp, nullptr, st);
    if (e != 0) return e;
  } else {
    const dim3 grid((ldg + GRAD_F32_COLS - 1) / GRAD_F32_COLS, nr);
    head_ce_grad_f32_kernel<<<grid, GRAD_F32_THREADS, 0, st>>>(
        static_cast<const float*>(logits), ldl, targets, l, sc, rows, vocab, gf, ldg, dp);
  }
  splitk_reduce_kernel<<<(vocab + 255) / 256, 256, 0, st>>>(dp, nr, 1, vocab, dbias, vocab, 0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return f32gemm::run_gemm(0, 0, gf, ldg, static_cast<const float*>(table), hidden, rows, hidden,
                           vocab, EPI_F32, 1, vocab, static_cast<float*>(dx), hidden, nullptr, 0,
                           nullptr, 0, nullptr, nullptr, nullptr, nullptr, st);
}

// The table's gradient out (vocab, hidden) f32 = g^T @ x in f32, g (rows,
// ldg) f32 as kvq_head_ce_bwd_f32 writes it, x (rows, hidden) f32: the f32
// GEMM's TN product in `splits` chunks of kchunk rows (ops/gemm.py
// `gemm_f32_plan`) whose partials in ws (splits, vocab, hidden) are summed in
// a fixed order.
int kvq_head_ce_dtable_f32(const void* g, int ldg, const void* x, int rows, int vocab,
                           int hidden, void* out, int splits, int kchunk, void* ws, void* stream) {
  if (ldg < vocab) return static_cast<int>(cudaErrorInvalidValue);
  return f32gemm::run_gemm(1, 0, static_cast<const float*>(g), ldg, static_cast<const float*>(x),
                           hidden, vocab, hidden, rows, EPI_F32, splits, kchunk,
                           static_cast<float*>(out), hidden, nullptr, 0, nullptr, 0, nullptr,
                           static_cast<float*>(ws), nullptr, nullptr,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
