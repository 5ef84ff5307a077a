// Building blocks shared by the layer kernels (layer_fwd.cu, layer_bwd.cu),
// the layer GEMM (gemm_sm90.cuh) and the fused head + CE kernels
// (head_ce.cu): the GELU of the JAX package (`_gelu_fwd` / `_gelu_grad`,
// ops/layer_pallas.py:214/221), warp reductions, the epilogue codes, the
// fixed-order split-K sum, cp.async, and a wmma GEMM.
//
// The wmma GEMM now serves head_ce.cu alone (#9's in-kernel mainloop, #10's
// dx GEMM and the table gradient); the layer's products moved to the wgmma +
// TMA GEMM of gemm_sm90.cuh. It is wmma 16x16x16 (bf16 operands, f32
// accumulate) on a 128x128x32 block tile, 8 warps of 64x32, with a two-stage
// cp.async pipeline and operands read transposed in place.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace kvq {

using namespace nvcuda;
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

// ---------------------------------------------------------------- GEMM
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int WARPS_M = 2, WARPS_N = 4;  // 8 warps, 64 x 32 warp tile
constexpr int GEMM_THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int STAGES = 2;
constexpr int PAD = 8;  // padded smem rows: 16-byte aligned, fewer bank conflicts

enum Epilogue {
  EPI_F32 = 0,         // C f32 = acc (+ bias in the forward)
  EPI_BF16 = 1,        // C bf16 = acc (+ bias in the forward)
  EPI_GELU_ERF = 2,    // forward only: C bf16 = gelu(acc + bias)
  EPI_GELU_TANH = 3,
  EPI_ADD_F32 = 4,     // C f32 = acc + aux (f32)
  EPI_ADD_BF16 = 5,    // C bf16 = acc + aux (f32)
  EPI_DGELU_ERF = 6,   // du = acc * gelu'(aux bf16): C bf16 = du, C2 f32 = du when given
  EPI_DGELU_TANH = 7,
  EPI_PARTIAL = 8,     // split-K partial: C f32 [split] = acc
};

struct GemmEpi {  // the wmma GEMM's output: C (f32 or bf16) with row stride ldc
  void* C;
  int ldc;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the ragged edge
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int EPI>
__device__ __forceinline__ void epilogue_store(const GemmEpi& e, int gr, int gc, float acc) {
  const size_t o = (size_t)gr * e.ldc + gc;
  if constexpr (EPI == EPI_F32) {
    static_cast<float*>(e.C)[o] = acc;
  } else {
    static_assert(EPI == EPI_BF16, "the wmma GEMM stores f32 or bf16");
    static_cast<bf16*>(e.C)[o] = __float2bfloat16(acc);
  }
}

// Shared-memory operand tiles of the mainloop below, in bf16 elements.
template <bool A_T, bool B_T>
struct GemmTiles {
  static constexpr int A_LD = A_T ? BM + PAD : BK + PAD;
  static constexpr int A_TILE = A_T ? BK * A_LD : BM * A_LD;
  static constexpr int B_LD = B_T ? BK + PAD : BN + PAD;
  static constexpr int B_TILE = B_T ? BN * B_LD : BK * B_LD;
  static constexpr int ELEMS = STAGES * (A_TILE + B_TILE);
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// The GEMM's mainloop: acc = op(A)[m0 + BM rows] @ op(B)[n0 + BN columns]
// over k in [kbeg, kend), each warp its WM x WN tile at (warp / WARPS_N,
// warp % WARPS_N), through smem (GemmTiles<A_T, B_T>::ELEMS bf16).
// A_T = false: A (M, K) row-major, element (m, k) at A[m * lda + k].
// A_T = true:  A stored (K, M) row-major, element (m, k) at A[k * lda + m].
// B_T = false: B (K, N) row-major;  B_T = true: B stored (N, K) row-major.
// The contiguous dimension of each operand must be a multiple of 8 and its
// rows 16-byte aligned (checked by the host); rows and columns past M, N
// and kend load as zeros. Returns after a barrier that follows the last read
// of smem, so the caller may reuse it.
template <bool A_T, bool B_T>
__device__ __forceinline__ void gemm_mainloop(bf16* smem, AccFrag (&acc)[FM][FN],
                                              const bf16* __restrict__ A, int lda,
                                              const bf16* __restrict__ B, int ldb, int M, int N,
                                              int m0, int n0, int kbeg, int kend) {
  typedef GemmTiles<A_T, B_T> T;
  constexpr int A_LD = T::A_LD, A_TILE = T::A_TILE, B_LD = T::B_LD, B_TILE = T::B_TILE;
  bf16* As = smem;
  bf16* Bs = smem + STAGES * A_TILE;

  typedef typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type ALayout;
  typedef typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type BLayout;

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto load_tile = [&](int stage, int k0) {
    bf16* as = As + stage * A_TILE;
    bf16* bs = Bs + stage * B_TILE;
    if (A_T) {  // rows of k, 128 contiguous m each
      for (int c = tid; c < BK * BM / 8; c += GEMM_THREADS) {
        const int r = c / (BM / 8), col = (c % (BM / 8)) * 8;
        const int gk = k0 + r, gm = m0 + col;
        const bool p = gk < kend && gm < M;
        cp_async16(as + r * A_LD + col, p ? A + (size_t)gk * lda + gm : A, p);
      }
    } else {  // rows of m, 32 contiguous k each
      for (int c = tid; c < BM * BK / 8; c += GEMM_THREADS) {
        const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const int gm = m0 + r, gk = k0 + col;
        const bool p = gm < M && gk < kend;
        cp_async16(as + r * A_LD + col, p ? A + (size_t)gm * lda + gk : A, p);
      }
    }
    if (B_T) {  // rows of n, 32 contiguous k each
      for (int c = tid; c < BN * BK / 8; c += GEMM_THREADS) {
        const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const int gn = n0 + r, gk = k0 + col;
        const bool p = gn < N && gk < kend;
        cp_async16(bs + r * B_LD + col, p ? B + (size_t)gn * ldb + gk : B, p);
      }
    } else {  // rows of k, 128 contiguous n each
      for (int c = tid; c < BK * BN / 8; c += GEMM_THREADS) {
        const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const int gk = k0 + r, gn = n0 + col;
        const bool p = gk < kend && gn < N;
        cp_async16(bs + r * B_LD + col, p ? B + (size_t)gk * ldb + gn : B, p);
      }
    }
  };

  const int nk = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  if (nk > 0) load_tile(0, kbeg);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile((kt + 1) % STAGES, kbeg + (kt + 1) * BK);
    cp_async_commit();  // possibly empty: keeps wait_group 1 meaning "tile kt has landed"
    cp_async_wait_1();
    __syncthreads();
    const bf16* as = As + (kt % STAGES) * A_TILE;
    const bf16* bs = Bs + (kt % STAGES) * B_TILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int mi = wm * WM + i * 16;
        wmma::load_matrix_sync(af[i], A_T ? as + kk * A_LD + mi : as + mi * A_LD + kk, A_LD);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int nj = wn * WN + j * 16;
        wmma::load_matrix_sync(bfr[j], B_T ? bs + nj * B_LD + kk : bs + kk * B_LD + nj, B_LD);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// C[M, N] = epi(op(A) @ op(B)) over k in [0, K), operands as gemm_mainloop,
// epilogue f32 or bf16. Two CTAs per SM: 128 registers a thread.
template <bool A_T, bool B_T, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb, GemmEpi e,
            int M, int N, int K) {
  static_assert(GemmTiles<A_T, B_T>::ELEMS * 2 >= GEMM_THREADS / 32 * 256 * 4, "epilogue scratch");
  __shared__ __align__(128) bf16 smem[GemmTiles<A_T, B_T>::ELEMS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  AccFrag acc[FM][FN];
  gemm_mainloop<A_T, B_T>(smem, acc, A, lda, B, ldb, M, N, m0, n0, 0, K);

  // epilogue: one 16x16 fragment at a time through a per-warp f32 scratch
  // that reuses the operand tiles' shared memory
  float* cs = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rbase = m0 + wm * WM + i * 16, cbase = n0 + wn * WN + j * 16;
      for (int q = lane; q < 256; q += 32) {
        const int gr = rbase + q / 16, gc = cbase + q % 16;
        if (gr < M && gc < N) epilogue_store<EPI>(e, gr, gc, cs[q]);
      }
      __syncwarp();
    }
  }
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

template <bool A_T, bool B_T, int EPI>
inline void launch_gemm(const void* A, int lda, const void* B, int ldb, const GemmEpi& e, int M,
                        int N, int K, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<A_T, B_T, EPI><<<grid, GEMM_THREADS, 0, st>>>(
      static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb, e, M, N, K);
}

}  // namespace kvq
