// Host launchers of layernorm.cu that other sources call: the layer
// forward's residual + LayerNorm (layer_fwd.cu) and the fixed-order sum of
// per-block column partials (gemm_sm90.cu, for the b1 sums of the GEMM's
// EPI_DGELU_* epilogue).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "dropout_hash.cuh"

namespace kvq {

// rows of at most this many columns (a multiple of 8) take the warp-a-row
// LayerNorm kernels (a row in a warp's registers, 16-byte chunks, four a
// lane); wider rows the block-a-row kernels, which take any width
constexpr int LN_WARP_WIDTH = 1024;

// out (M, N) = LN(float(x) + drop(a)) with flax's fast variance; x and out
// f32 when f32, else bf16; a f32 (M, N), gamma / beta (N,) f32, every
// pointer but inv 16-byte aligned; inv (M,) f32 receives each row's rsqrt
// when not null. N any multiple of 8. Returns cudaErrorInvalidValue for a
// width or alignment it does not take.
cudaError_t residual_layernorm(const void* x, const void* a, const void* gamma, const void* beta,
                               void* out, float* inv, int M, int N, float eps, DropoutParams drop,
                               uint32_t op, bool f32, cudaStream_t st);

// out[c] = sum over b < nparts of parts[b * width + c], c < width (even), in
// a fixed order.
cudaError_t colparts_reduce(const float* parts, int nparts, int width, float* out,
                            cudaStream_t st);

}  // namespace kvq
