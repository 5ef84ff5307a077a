// Building blocks shared by the layer kernels (layer_fwd.cu, layer_bwd.cu),
// the GEMMs (gemm_sm90.cuh, gemm_f32.cu), the attention (attention.cuh,
// attention_f32.cuh) and the fused head + CE kernels (head_ce.cu and the f32
// GEMM's CE epilogues): the GELU of the JAX package (`_gelu_fwd` /
// `_gelu_grad`, ops/layer_pallas.py:214/221), warp reductions, the CE's row
// partials and gradient element, the GEMM's epilogue codes, the TF32 split
// of the 3xTF32 products, the fixed-order split-K sum, cp.async, and the
// division's correctly rounded forms without its slow-path call (the long
// attention, attention_long.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace kvq {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- GELU
// erf(x) ~ tanh(x * p(x^2)): the degree-13 fit of layer_pallas.py _ERF_P
__device__ __forceinline__ float erf_poly(float z2) {
  float acc = 1.5896024415e-07f;
  acc = acc * z2 + -5.9856910908e-06f;
  acc = acc * z2 + 8.9712590414e-05f;
  acc = acc * z2 + -6.2571958331e-04f;
  acc = acc * z2 + -1.8438367938e-04f;
  acc = acc * z2 + 1.0276548145e-01f;
  acc = acc * z2 + 1.1283797055e+00f;
  return acc;
}

// p'(z) as a polynomial in z^2: Horner over (2k+1) c_k (layer_pallas.py _erf_dp)
__device__ __forceinline__ float erf_dpoly(float z2) {
  float acc = 13.0f * 1.5896024415e-07f;
  acc = acc * z2 + 11.0f * -5.9856910908e-06f;
  acc = acc * z2 + 9.0f * 8.9712590414e-05f;
  acc = acc * z2 + 7.0f * -6.2571958331e-04f;
  acc = acc * z2 + 5.0f * -1.8438367938e-04f;
  acc = acc * z2 + 3.0f * 1.0276548145e-01f;
  acc = acc * z2 + 1.0f * 1.1283797055e+00f;
  return acc;
}

constexpr float INV_SQRT2 = 0.707106781186547524f;
constexpr float TANH_C = 0.797884560802865355f;  // sqrt(2 / pi)

// u / sqrt(2) correctly rounded, as the division gives it, but without its
// slow-path branch (which keeps a GEMM epilogue from running its elements
// side by side): the product with the rounded reciprocal, then one exact
// residual step (Markstein: RN(1/c) within half an ulp and q within one ulp
// give the correctly rounded quotient)
__device__ __forceinline__ float div_sqrt2(float u) {
  constexpr float SQRT2 = 1.41421356237309515f;
  const float q = u * INV_SQRT2;
  return fmaf(fmaf(-q, SQRT2, u), INV_SQRT2, q);
}

// RN(1 / z) for a normal z, as the division gives it, but without its
// slow-path call (around which ptxas spills registers): three Newton steps
// in f64 from rcp.approx (a relative error of a few 2^-53), then one
// rounding to f32, which gives RN(1 / z) because 1 / z lies at least 2^-49
// (relative) from every midpoint of two floats. tests/test_torch_cuda.py
// test_division_without_its_slow_path checks it on the card for every z in
// [1, 512].
__device__ __forceinline__ float rcp_rn(float z) {
  const double d = z;
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;\n" : "=d"(y) : "d"(d));
#pragma unroll
  for (int k = 0; k < 3; ++k) y = fma(y, fma(-d, y, 1.0), y);
  return static_cast<float>(y);
}

// e / z correctly rounded, as the division gives it, for a quotient in the
// normal range (below it, within a subnormal ulp), without its slow-path
// call: q = e rz within an ulp (rz = rcp_rn(z)), then Markstein's residual
// step, as div_sqrt2 above
__device__ __forceinline__ float div_rn(float e, float z, float rz) {
  const float q = e * rz;
  return fmaf(fmaf(-q, z, e), rz, q);
}

__device__ __forceinline__ float gelu_erf(float u) {
  const float z = div_sqrt2(u);
  return 0.5f * u * (1.0f + tanhf(z * erf_poly(z * z)));
}

__device__ __forceinline__ float gelu_tanh(float u) {
  const float w = TANH_C * (u + 0.044715f * u * u * u);
  return 0.5f * u * (1.0f + tanhf(w));
}

// the derivative of the polynomial form above, not the true erf'
__device__ __forceinline__ float gelu_erf_grad(float u) {
  const float z = u * INV_SQRT2;
  const float z2 = z * z;
  const float t = tanhf(z * erf_poly(z2));
  return 0.5f * (1.0f + t) + (0.5f * INV_SQRT2) * u * (1.0f - t * t) * erf_dpoly(z2);
}

__device__ __forceinline__ float gelu_tanh_grad(float u) {
  const float w = TANH_C * (u + 0.044715f * u * u * u);
  const float t = tanhf(w);
  return 0.5f * (1.0f + t) + 0.5f * u * (1.0f - t * t) * TANH_C * (1.0f + 3.0f * 0.044715f * u * u);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ------------------------------------------------ fused head + CE
// One row's reduction over some columns: max (also the argmax's value), sum
// of exp(l - max), target logit, and the first column holding the max.
struct Part {
  float m, s, t;
  int i;
};

// a <- a merged with b; equal maxima keep the lower column
__device__ __forceinline__ void merge(Part& a, const Part& b) {
  const float m = fmaxf(a.m, b.m);
  a.s = m == -INFINITY ? 0.0f : a.s * expf(a.m - m) + b.s * expf(b.m - m);
  if (b.m > a.m || (b.m == a.m && b.i < a.i)) a.i = b.i;
  a.m = m;
  a.t += b.t;
}

// one element of the f32 gradient. The _rn intrinsics keep the compiler from
// fusing any step into a neighbour, so every #10 kernel rounds it alike.
__device__ __forceinline__ float ce_grad(float l, float lse, bool target, float scale) {
  return __fmul_rn(__fsub_rn(expf(__fsub_rn(l, lse)), target ? 1.0f : 0.0f), scale);
}

// ---------------------------------------------------- GEMM epilogues
enum Epilogue {
  EPI_F32 = 0,         // C f32 = acc (+ bias in the forward)
  EPI_BF16 = 1,        // C bf16 = acc (+ bias in the forward)
  EPI_GELU_ERF = 2,    // forward only: C bf16 = gelu(acc + bias)
  EPI_GELU_TANH = 3,
  EPI_ADD_F32 = 4,     // C f32 = acc + aux (f32)
  EPI_ADD_BF16 = 5,    // C bf16 = acc + aux (f32)
  EPI_DGELU_ERF = 6,   // du = acc * gelu'(aux bf16): C bf16 = du, C2 f32 = du when given,
                       // du's column partials when asked (Args::colpart)
  EPI_DGELU_TANH = 7,
  EPI_PARTIAL = 8,     // split-K partial: C f32 [split] = acc
  EPI_CE_FWD = 9,      // fused head + CE forward (head_ce.cu, gemm_f32.cu): logits, per-tile
                       // CE partials
  EPI_CE_BWD = 10,     // fused head + CE backward (head_ce.cu, gemm_f32.cu): g, dbias partials
  EPI_VQ_CROSS = 11,   // the VQ's distances (vq_fwd.cu, gemm_f32.cu): C f32 = (A - aux) B^T, A's
                       // rows centred by aux (K,) as they are split
};

// the tf32 value of x, rounded to nearest with ties away from zero, as an
// f32 bit pattern whose 13 low bits cvt.rna leaves zero (tests/
// test_torch_cuda.py test_tf32_conversion_zeroes_the_low_bits checks it on
// the card): no mask before x - big
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// to_tf32's bits on two integer operations: the magnitude rounded half up at
// bit 13, then the 13 low bits cleared. The same bits as cvt.rna for every x
// that is not a NaN (test_torch_cuda.py test_tf32_conversion_zeroes_the_low_bits
// checks all 2^32 patterns on the card); ptxas lowers the cvt to a longer
// sequence that also quiets NaNs.
__device__ __forceinline__ uint32_t to_tf32_int(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: the TF32 rounding of x and that of its remainder, the
// operands of a 3xTF32 product (small * big + big * small + big * big;
// small * small, 2^-22 relative, dropped): the f32 GEMM (gemm_f32.cu) on
// cvt.rna, the f32 attention (attention_f32.cuh, INT) on to_tf32_int, where
// the split is a large share of the instructions
template <bool INT = false>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  if constexpr (INT) {
    big = to_tf32_int(x);
    small = to_tf32_int(x - __uint_as_float(big));
  } else {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the ragged edge
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

// out[r, c] = sum over z of ws[z, r, c] (f32 or rounded to bf16) for a
// split-K product, summed in a fixed order. Static: each source that
// includes this header gets its own copy.
static __global__ void splitk_reduce_kernel(const float* __restrict__ ws, int splits, int M, int N,
                                            void* __restrict__ out, int ldc, int to_bf16) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += ws[(size_t)z * total + i];
  const size_t r = i / N, c = i % N;
  if (to_bf16)
    static_cast<bf16*>(out)[r * ldc + c] = __float2bfloat16(s);
  else
    static_cast<float*>(out)[r * ldc + c] = s;
}

}  // namespace kvq
