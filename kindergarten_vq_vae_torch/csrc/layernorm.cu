// LayerNorm and column sums of the fused BertLayer for Hopper (sm_90a).
//
// Replaces, inside kindergarten_vq_vae_tpu/ops/layer_pallas.py
// `_layer_fwd_kernel` (l.489), the residual + LayerNorm after each
// projection (`_ln_fwd` l.164, with the hidden dropout of `_keep_2d` l.142)
// and, inside `_layer_bwd_kernel` (l.552), the LayerNorm backward (`_ln_bwd`
// l.175 from `_ln_recover_yhat` l.542) with its dgamma / dbeta / bias column
// sums, and the other bias gradients' column sums. Entry points:
//
//   kvq_residual_layernorm   out = LN(x + drop(a)) and each row's rsqrt
//   kvq_ln_bwd               dr, da = dr * keep, and the sums over rows of
//                            gy * yhat, gy and da
//   kvq_colsum               f32 column sums of a bf16 or f32 matrix
//
// Each kernel is a template on the element type of the rows it reads and
// writes (x, out, v, da, src): bf16, or f32 for an f32 run (JAX's parity
// dtype, whose Pallas kernels run in the compute dtype); the f32 instances
// do the same arithmetic, a lane's 8 columns as two 16-byte chunks.
//
// and, for the other sources (layernorm.cuh), residual_layernorm (the layer
// forward's C sequence) and colparts_reduce (also the b1 sum of the GEMM's
// EPI_DGELU_* column partials).
//
// What bounds them on the H100: bytes. At 24,576 rows x 768 a LayerNorm
// backward moves 189 or 227 MB (bf16 or f32 upstream), a residual +
// LayerNorm 151 MB, against ~3 operations a byte (the f32 units' ~20 a byte
// of memory rate). What the design does about it:
// - one warp a row, each lane chunks of 8 adjacent columns (lane,
//   lane + 32, ...): the row is read once into registers and written once,
//   with 16-byte loads and stores; mean and E[r^2] (or the backward's two
//   row means) by shuffles;
// - the hash's row term once a row, each keep drawn once;
// - the backward's column sums over every row stay deterministic: each warp
//   keeps its lanes' columns' sums in registers over its rows of the
//   block's LNB_ROWS; the block's warps are added in shared memory in warp
//   order and written as one partial a block; colparts_reduce adds the
//   partials in a fixed order, spread over the card (strips of partials a
//   warp, then the strips in order). The partials depend on M alone, so
//   every card gives the same bits;
// - yhat = (v - beta) / gamma by a true division (0 where gamma is 0), the
//   rounding of `_ln_recover_yhat`.
// Rows wider than LN_WARP_WIDTH (1,024: four 16-byte chunks a lane) take
// block-a-row kernels that hold no row in registers and so take any width
// (a multiple of 8): the residual + LayerNorm reads its row twice (sums,
// then the output; the second read mostly from L2) with the row's sums
// reduced through shared memory in warp order; the backward is a launch a
// block a row for each row's two means, then a launch over (64-row block,
// 256-column strip) tiles that writes dr and da and the column partials
// (the same (blocks, 3, N) layout, the same fixed-order reduce), so it reads
// gy and v twice.

#include <cuda_bf16.h>

#include <type_traits>

#include "dropout_hash.cuh"
#include "layer_common.cuh"
#include "layernorm.cuh"

namespace kvq {

namespace {

constexpr int LN_THREADS = 256;              // forward: 8 rows a block, a warp a row
constexpr int LNB_WARPS = 4, LNB_ROWS = 64;  // backward: 4 warps over a block's 64 rows
constexpr int CS_WARPS = 8, CS_ROWS = 256;   // column sums: 8 warps over 256 rows x 256 columns
constexpr int RED_WARPS = 8;                 // reduce: 8 strips of partials, 64 columns a block
constexpr int LNW_THREADS = 128;             // rows past LN_WARP_WIDTH: a block of 4 warps a row

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ------------------------------------------------- residual + LayerNorm
// out = LN(float(x) + drop(a)), one warp a row of N <= 256 CPL columns;
// inv (M,) receives each row's rsqrt when given.
template <int CPL, typename T>
__global__ void __launch_bounds__(LN_THREADS)
residual_layernorm_kernel(const T* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          T* __restrict__ out, float* __restrict__ inv_out, int M, int N,
                          float eps, DropoutParams drop, uint32_t op) {
  const int row = blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const size_t base = (size_t)row * N;
  float r[CPL][8], xv[CPL][8];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c0 = 8 * (lane + 32 * i);
    if (c0 < N) {
      load8(x + base + c0, xv[i]);
      load8(a + base + c0, r[i]);
    }
  }
  const uint32_t rt = dropout_row_term(row, op, drop.seed);
  float s = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c0 = 8 * (lane + 32 * i);
    if (c0 < N) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float av = drop.on ? r[i][k] * dropout_keep(rt, c0 + k, drop) : r[i][k];
        r[i][k] = xv[i][k] + av;
        s += r[i][k];
        s2 += r[i][k] * r[i][k];
      }
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / N;
  const float var = fmaxf(s2 / N - mu * mu, 0.0f);
  const float inv = rsqrtf(var + eps);
  if (inv_out != nullptr && lane == 0) inv_out[row] = inv;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c0 = 8 * (lane + 32 * i);
    if (c0 < N) {
      float g[8], b[8];
      load8(gamma + c0, g);
      load8(beta + c0, b);
#pragma unroll
      for (int k = 0; k < 8; ++k) r[i][k] = (r[i][k] - mu) * inv * g[k] + b[k];
      store8(out + base + c0, r[i]);
    }
  }
}

// ------------------------------------------------- LayerNorm backward
// Rows [blockIdx.x * LNB_ROWS, +LNB_ROWS), warp w the rows w, w + LNB_WARPS,
// ... of them. gy (M, N) f32 or bf16 upstream; v the stored LN output (M, N)
// in T, yhat = (v - beta) / gamma (0 where gamma is 0); inv (M,) the
// forward's rsqrt. dr (M, N) f32 = inv * (dyhat - mean(dyhat) -
// yhat * mean(dyhat * yhat)), dyhat = gy * gamma; da (M, N) in T = dr * keep.
// parts (gridDim.x, 3, N): the block's column sums of gy * yhat, gy and
// dr * keep (f32, before rounding). Dynamic shared memory: gamma, beta and
// the block's sums, 5 N floats.
template <int CPL, bool GY_F32, typename T>
__global__ void __launch_bounds__(32 * LNB_WARPS, CPL <= 3 ? 3 : 2)
ln_bwd_kernel(const void* __restrict__ gy_, const T* __restrict__ v,
              const float* __restrict__ inv, const float* __restrict__ gamma,
              const float* __restrict__ beta, DropoutParams drop, uint32_t op,
              float* __restrict__ dr, T* __restrict__ da, float* __restrict__ parts, int M,
              int N) {
  extern __shared__ float4 ln_smem[];
  float* gs = reinterpret_cast<float*>(ln_smem);
  float* bs = gs + N;
  float* sums = bs + N;
  typedef typename std::conditional<GY_F32, float, bf16>::type GyT;
  const GyT* gy = static_cast<const GyT*>(gy_);
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    gs[c] = gamma[c];
    bs[c] = beta[c];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * LNB_ROWS;
  float cg[CPL][8], cb[CPL][8], ca[CPL][8];  // this lane's columns' sums over the warp's rows
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) cg[i][k] = cb[i][k] = ca[i][k] = 0.0f;

  for (int rr = warp; rr < LNB_ROWS; rr += LNB_WARPS) {
    const int row = r0 + rr;
    if (row >= M) break;
    const size_t base = (size_t)row * N;
    float g[CPL][8], y[CPL][8];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c0 = 8 * (lane + 32 * i);
      if (c0 < N) {
        load8(gy + base + c0, g[i]);
        load8(v + base + c0, y[i]);
      }
    }
    const float iv = inv[row];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c0 = 8 * (lane + 32 * i);
      if (c0 < N) {
        float gm[8], bt[8];
        load8(gs + c0, gm);
        load8(bs + c0, bt);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          y[i][k] = gm[k] == 0.0f ? 0.0f : __fdiv_rn(y[i][k] - bt[k], gm[k]);
          const float dyh = g[i][k] * gm[k];
          s1 += dyh;
          s2 += dyh * y[i][k];
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float m1 = s1 / N, m2 = s2 / N;
    const uint32_t rt = dropout_row_term(row, op, drop.seed);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c0 = 8 * (lane + 32 * i);
      if (c0 < N) {
        float gm[8], d[8], o[8];
        load8(gs + c0, gm);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          d[k] = iv * (g[i][k] * gm[k] - m1 - y[i][k] * m2);
          o[k] = drop.on ? d[k] * dropout_keep(rt, c0 + k, drop) : d[k];
          cg[i][k] += g[i][k] * y[i][k];
          cb[i][k] += g[i][k];
          ca[i][k] += o[k];
        }
        store8(dr + base + c0, d);
        store8(da + base + c0, o);
      }
    }
  }

  // the block's sums: the warps in order through shared memory, the last
  // one straight to the block's partial
  float* part = parts + (size_t)blockIdx.x * 3 * N;
  for (int w = 0; w < LNB_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c0 = 8 * (lane + 32 * i);
        if (c0 >= N) continue;
        auto add = [&](int q, const float (&mine)[8]) {
          float t[8];
          if (w > 0) {
            load8(sums + q * N + c0, t);
#pragma unroll
            for (int k = 0; k < 8; ++k) t[k] += mine[k];
          } else {
#pragma unroll
            for (int k = 0; k < 8; ++k) t[k] = mine[k];
          }
          store8((w + 1 < LNB_WARPS ? sums : part) + q * N + c0, t);
        };
        add(0, cg[i]);
        add(1, cb[i]);
        add(2, ca[i]);
      }
    }
    if (w + 1 < LNB_WARPS) __syncthreads();
  }
}

// ------------------------------------------- rows past LN_WARP_WIDTH
// A block of LNW_THREADS a row: thread t takes the 8-column chunks t, t +
// LNW_THREADS, ... of it. The sums: each thread's chunks in order, a warp's
// lanes by shuffles, then the warps in order through shared memory.

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < LNW_THREADS / 32; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// r = float(x) + drop(a) for one chunk, with the rounding written out (no
// FMA), so that both passes of the wide forward give the same bits
template <typename T>
__device__ __forceinline__ void residual_chunk(const T* x, const float* a, uint32_t rt, int c0,
                                               const DropoutParams& drop, float (&r)[8]) {
  float xv[8];
  load8(x, xv);
  load8(a, r);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r[k] = __fadd_rn(xv[k], drop.on ? __fmul_rn(r[k], dropout_keep(rt, c0 + k, drop)) : r[k]);
}

// out = LN(float(x) + drop(a)) of row blockIdx.x, any width N (a multiple of 8)
template <typename T>
__global__ void __launch_bounds__(LNW_THREADS)
residual_layernorm_wide_kernel(const T* __restrict__ x, const float* __restrict__ a,
                               const float* __restrict__ gamma, const float* __restrict__ beta,
                               T* __restrict__ out, float* __restrict__ inv_out, int N, float eps,
                               DropoutParams drop, uint32_t op) {
  __shared__ float red[LNW_THREADS / 32];
  const int row = blockIdx.x;
  const size_t base = (size_t)row * N;
  const uint32_t rt = dropout_row_term(row, op, drop.seed);
  float s = 0.0f, s2 = 0.0f;
  for (int c0 = 8 * threadIdx.x; c0 < N; c0 += 8 * LNW_THREADS) {
    float r[8];
    residual_chunk(x + base + c0, a + base + c0, rt, c0, drop, r);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s += r[k];
      s2 += r[k] * r[k];
    }
  }
  s = block_sum(s, red);
  s2 = block_sum(s2, red);
  const float mu = s / N;
  const float var = fmaxf(s2 / N - mu * mu, 0.0f);
  const float inv = rsqrtf(var + eps);
  if (inv_out != nullptr && threadIdx.x == 0) inv_out[row] = inv;
  for (int c0 = 8 * threadIdx.x; c0 < N; c0 += 8 * LNW_THREADS) {
    float r[8], g[8], b[8];
    residual_chunk(x + base + c0, a + base + c0, rt, c0, drop, r);
    load8(gamma + c0, g);
    load8(beta + c0, b);
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = (r[k] - mu) * inv * g[k] + b[k];
    store8(out + base + c0, r);
  }
}

// yhat of one element: (v - beta) / gamma, 0 where gamma is 0
__device__ __forceinline__ float ln_yhat(float v, float b, float g) {
  return g == 0.0f ? 0.0f : __fdiv_rn(v - b, g);
}

// The wide backward's first launch: m (M, 2) receives row blockIdx.x's
// mean(dyhat) and mean(dyhat * yhat), dyhat = gy * gamma.
template <bool GY_F32, typename T>
__global__ void __launch_bounds__(LNW_THREADS)
ln_bwd_wide_means_kernel(const void* __restrict__ gy_, const T* __restrict__ v,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         float* __restrict__ m, int N) {
  __shared__ float red[LNW_THREADS / 32];
  typedef typename std::conditional<GY_F32, float, bf16>::type GyT;
  const GyT* gy = static_cast<const GyT*>(gy_);
  const size_t base = (size_t)blockIdx.x * N;
  float s1 = 0.0f, s2 = 0.0f;
  for (int c0 = 8 * threadIdx.x; c0 < N; c0 += 8 * LNW_THREADS) {
    float g[8], y[8];
    load8(gy + base + c0, g);
    load8(v + base + c0, y);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float gm = gamma[c0 + k], dyh = g[k] * gm;  // gamma, beta: any alignment
      s1 += dyh;
      s2 += dyh * ln_yhat(y[k], beta[c0 + k], gm);
    }
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    m[2 * blockIdx.x] = s1 / N;
    m[2 * blockIdx.x + 1] = s2 / N;
  }
}

// The wide backward's second launch: block (256-column strip blockIdx.x,
// rows [blockIdx.y * LNB_ROWS, +LNB_ROWS)), warp w the rows w, w +
// LNB_WARPS, ... of them, each lane 8 adjacent columns. dr, da as
// ln_bwd_kernel, from the row means m; parts (gridDim.y, 3, N): the block's
// column sums of gy * yhat, gy and dr * keep, the warps added in order.
template <bool GY_F32, typename T>
__global__ void __launch_bounds__(32 * LNB_WARPS)
ln_bwd_wide_kernel(const void* __restrict__ gy_, const T* __restrict__ v,
                   const float* __restrict__ inv, const float* __restrict__ m,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   DropoutParams drop, uint32_t op, float* __restrict__ dr, T* __restrict__ da,
                   float* __restrict__ parts, int M, int N) {
  __shared__ __align__(16) float sums[3][256];
  typedef typename std::conditional<GY_F32, float, bf16>::type GyT;
  const GyT* gy = static_cast<const GyT*>(gy_);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * 256 + 8 * lane, r0 = blockIdx.y * LNB_ROWS;
  const bool in = c0 < N;
  float gm[8], bt[8], cg[8], cb[8], ca[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) cg[k] = cb[k] = ca[k] = 0.0f;
  if (in) {
#pragma unroll
    for (int k = 0; k < 8; ++k) gm[k] = gamma[c0 + k], bt[k] = beta[c0 + k];
    for (int rr = warp; rr < LNB_ROWS; rr += LNB_WARPS) {
      const int row = r0 + rr;
      if (row >= M) break;
      const size_t at = (size_t)row * N + c0;
      float g[8], y[8], d[8], o[8];
      load8(gy + at, g);
      load8(v + at, y);
      const float iv = inv[row], m1 = m[2 * row], m2 = m[2 * row + 1];
      const uint32_t rt = dropout_row_term(row, op, drop.seed);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        y[k] = ln_yhat(y[k], bt[k], gm[k]);
        d[k] = iv * (g[k] * gm[k] - m1 - y[k] * m2);
        o[k] = drop.on ? d[k] * dropout_keep(rt, c0 + k, drop) : d[k];
        cg[k] += g[k] * y[k];
        cb[k] += g[k];
        ca[k] += o[k];
      }
      store8(dr + at, d);
      store8(da + at, o);
    }
  }
  float* part = parts + (size_t)blockIdx.y * 3 * N;
  for (int w = 0; w < LNB_WARPS; ++w) {
    if (warp == w && in) {
      auto add = [&](int q, const float (&mine)[8]) {
        float t[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) t[k] = (w > 0 ? sums[q][8 * lane + k] : 0.0f) + mine[k];
        if (w + 1 < LNB_WARPS)
          store8(&sums[q][8 * lane], t);
        else
          store8(part + q * N + c0, t);
      };
      add(0, cg);
      add(1, cb);
      add(2, ca);
    }
    if (w + 1 < LNB_WARPS) __syncthreads();
  }
}

// ------------------------------------------------------ column sums
// parts[blockIdx.y, c] = sum of src[r, c] over the block's CS_ROWS rows, for
// the block's 256 columns: each lane 8 adjacent columns (16-byte loads),
// warp w the rows w, w + CS_WARPS, ...; then the warps in order.
template <typename T>
__global__ void __launch_bounds__(32 * CS_WARPS)
colsum_kernel(const T* __restrict__ src, int M, int N, float* __restrict__ parts) {
  __shared__ __align__(16) float strip[CS_WARPS][256];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * 256 + 8 * lane;
  const int r1 = min(M, (static_cast<int>(blockIdx.y) + 1) * CS_ROWS);
  float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (c0 < N) {
#pragma unroll 4
    for (int r = static_cast<int>(blockIdx.y) * CS_ROWS + warp; r < r1; r += CS_WARPS) {
      float f[8];
      load8(src + (size_t)r * N + c0, f);
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] += f[k];
    }
  }
  store8(&strip[warp][8 * lane], s);
  __syncthreads();
  const int t = threadIdx.x, c = blockIdx.x * 256 + t;  // 256 threads: a column each
  if (c < N) {
    float sum = strip[0][t];
#pragma unroll
    for (int w = 1; w < CS_WARPS; ++w) sum += strip[w][t];
    parts[(size_t)blockIdx.y * N + c] = sum;
  }
}

// out[c] = sum over b of parts[b * width + c]: RED_WARPS strips of partials
// (warp w: partials w, w + RED_WARPS, ...), a column pair a lane, then the
// strips in order.
__global__ void __launch_bounds__(32 * RED_WARPS)
colparts_reduce_kernel(const float* __restrict__ parts, int nparts, int width,
                       float* __restrict__ out) {
  __shared__ float2 strip[RED_WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 64 + 2 * lane;
  float2 s = make_float2(0.0f, 0.0f);
  if (c < width) {
#pragma unroll 4
    for (int b = warp; b < nparts; b += RED_WARPS) {
      const float2 t = *reinterpret_cast<const float2*>(parts + (size_t)b * width + c);
      s.x += t.x;
      s.y += t.y;
    }
  }
  strip[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < width) {
#pragma unroll
    for (int w = 1; w < RED_WARPS; ++w) {
      s.x += strip[w][lane].x;
      s.y += strip[w][lane].y;
    }
    *reinterpret_cast<float2*>(out + c) = s;
  }
}

template <bool GY_F32, typename T>
void launch_ln_bwd(int cpl, int blocks, size_t smem, cudaStream_t st, const void* gy,
                   const void* v, const float* inv, const float* g, const float* b,
                   DropoutParams drop, uint32_t op, float* dr, void* da, float* parts, int M,
                   int N) {
  const T* vt = static_cast<const T*>(v);
  T* dat = static_cast<T*>(da);
#define KVQ_LNB(C)                                                                     \
  ln_bwd_kernel<C, GY_F32, T><<<blocks, 32 * LNB_WARPS, smem, st>>>(gy, vt, inv, g, b, drop, \
                                                                    op, dr, dat, parts, M, N)
  switch (cpl) {
    case 1: KVQ_LNB(1); break;
    case 2: KVQ_LNB(2); break;
    case 3: KVQ_LNB(3); break;
    default: KVQ_LNB(4); break;
  }
#undef KVQ_LNB
}

template <typename T>
void launch_residual_layernorm(int blocks, cudaStream_t st, const void* x, const float* a,
                               const float* g, const float* b, void* out, float* inv, int M,
                               int N, float eps, DropoutParams drop, uint32_t op) {
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
#define KVQ_LN(C)                                                                           \
  residual_layernorm_kernel<C, T><<<blocks, LN_THREADS, 0, st>>>(xt, a, g, b, o, inv, M, N, eps, \
                                                                 drop, op)
  switch ((N + 255) / 256) {
    case 1: KVQ_LN(1); break;
    case 2: KVQ_LN(2); break;
    case 3: KVQ_LN(3); break;
    default: KVQ_LN(4); break;
  }
#undef KVQ_LN
}

}  // namespace

cudaError_t residual_layernorm(const void* x, const void* a, const void* gamma, const void* beta,
                               void* out, float* inv, int M, int N, float eps, DropoutParams drop,
                               uint32_t op, bool f32, cudaStream_t st) {
  if (N <= 0 || N % 8 != 0 || M < 0 || !aligned16(x) || !aligned16(a) || !aligned16(gamma) ||
      !aligned16(beta) || !aligned16(out))
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  const int blocks = (M + LN_THREADS / 32 - 1) / (LN_THREADS / 32);
  const float *af = static_cast<const float*>(a), *g = static_cast<const float*>(gamma),
              *b = static_cast<const float*>(beta);
  if (N > LN_WARP_WIDTH) {
    if (f32)
      residual_layernorm_wide_kernel<<<M, LNW_THREADS, 0, st>>>(
          static_cast<const float*>(x), af, g, b, static_cast<float*>(out), inv, N, eps, drop, op);
    else
      residual_layernorm_wide_kernel<<<M, LNW_THREADS, 0, st>>>(
          static_cast<const bf16*>(x), af, g, b, static_cast<bf16*>(out), inv, N, eps, drop, op);
  } else if (f32)
    launch_residual_layernorm<float>(blocks, st, x, af, g, b, out, inv, M, N, eps, drop, op);
  else
    launch_residual_layernorm<bf16>(blocks, st, x, af, g, b, out, inv, M, N, eps, drop, op);
  return cudaGetLastError();
}

cudaError_t colparts_reduce(const float* parts, int nparts, int width, float* out,
                            cudaStream_t st) {
  if (width <= 0 || width % 2 != 0 || nparts <= 0) return cudaErrorInvalidValue;
  colparts_reduce_kernel<<<(width + 63) / 64, 32 * RED_WARPS, 0, st>>>(parts, nparts, width, out);
  return cudaGetLastError();
}

}  // namespace kvq

using namespace kvq;

extern "C" {

// Residual + LayerNorm of M rows of width N (see residual_layernorm); x and
// out f32 when f32, else bf16; seed the int32 seed's bits, thresh / scale the
// hidden dropout's (thresh 0: off), op the site's id.
int kvq_residual_layernorm(const void* x, const void* a, const void* gamma, const void* beta,
                           void* out, void* inv, int M, int N, float eps, unsigned seed,
                           unsigned thresh, float scale, unsigned op, int f32, void* stream) {
  const DropoutParams drop{seed, thresh, scale, thresh != 0u};
  return static_cast<int>(residual_layernorm(x, a, gamma, beta, out, static_cast<float*>(inv), M,
                                             N, eps, drop, op, f32 != 0,
                                             static_cast<cudaStream_t>(stream)));
}

// LayerNorm backward of M rows of width N (see ln_bwd_kernel; any multiple
// of 8): v and da f32 when f32 (gy then f32 too), else bf16. parts f32
// scratch: (ceil(M / 64), 3, N), then 2 M floats (the wide rows' means);
// sums (3, N) f32 receives [sum gy * yhat, sum gy, sum dr * keep].
int kvq_ln_bwd(const void* gy, int gy_f32, const void* v, const void* inv, const void* gamma,
               const void* beta, unsigned seed, unsigned thresh, float scale, unsigned op,
               void* dr, void* da, void* parts, void* sums, int M, int N, int f32,
               void* stream) {
  if (N <= 0 || N % 8 != 0 || M <= 0 || !aligned16(gy) || !aligned16(v) || dr == nullptr ||
      !aligned16(dr) || !aligned16(da) || !aligned16(parts) || (f32 && !gy_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutParams drop{seed, thresh, scale, thresh != 0u};
  const int blocks = (M + LNB_ROWS - 1) / LNB_ROWS, cpl = (N + 255) / 256;
  const size_t smem = 5 * (size_t)N * sizeof(float);
  auto *iv = static_cast<const float*>(inv), *g = static_cast<const float*>(gamma),
       *b = static_cast<const float*>(beta);
  auto* drf = static_cast<float*>(dr);
  auto* p = static_cast<float*>(parts);
  if (N > LN_WARP_WIDTH) {
    float* means = p + (size_t)blocks * 3 * N;
    const dim3 grid(cpl, blocks);
#define KVQ_LNW(GF, T)                                                                        \
  ln_bwd_wide_means_kernel<GF, T><<<M, LNW_THREADS, 0, st>>>(gy, static_cast<const T*>(v), g, b, \
                                                            means, N);                         \
  ln_bwd_wide_kernel<GF, T><<<grid, 32 * LNB_WARPS, 0, st>>>(                                  \
      gy, static_cast<const T*>(v), iv, means, g, b, drop, op, drf, static_cast<T*>(da), p, M, N)
    if (f32) {
      KVQ_LNW(true, float);
    } else if (gy_f32) {
      KVQ_LNW(true, bf16);
    } else {
      KVQ_LNW(false, bf16);
    }
#undef KVQ_LNW
  } else if (f32)
    launch_ln_bwd<true, float>(cpl, blocks, smem, st, gy, v, iv, g, b, drop, op, drf, da, p, M, N);
  else if (gy_f32)
    launch_ln_bwd<true, bf16>(cpl, blocks, smem, st, gy, v, iv, g, b, drop, op, drf, da, p, M, N);
  else
    launch_ln_bwd<false, bf16>(cpl, blocks, smem, st, gy, v, iv, g, b, drop, op, drf, da, p, M, N);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(colparts_reduce(p, blocks, 3 * N, static_cast<float*>(sums), st));
}

// out (N,) f32 = column sums of src (M, N), f32 when f32 else bf16, N a
// multiple of 8, src 16-byte aligned. parts (ceil(M / 256), N) f32 scratch.
int kvq_colsum(const void* src, int M, int N, void* parts, void* out, int f32, void* stream) {
  if (N <= 0 || N % 8 != 0 || M <= 0 || !aligned16(src))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + 255) / 256, (M + CS_ROWS - 1) / CS_ROWS);
  auto* p = static_cast<float*>(parts);
  if (f32)
    colsum_kernel<<<grid, 32 * CS_WARPS, 0, st>>>(static_cast<const float*>(src), M, N, p);
  else
    colsum_kernel<<<grid, 32 * CS_WARPS, 0, st>>>(static_cast<const bf16*>(src), M, N, p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(colparts_reduce(p, grid.y, N, static_cast<float*>(out), st));
}

}  // extern "C"
