// The f32 instance of the layer GEMM (gemm_f32.cu): the host entry that the
// layer forward's C sequence (layer_fwd.cu) calls for f32 operands.
#pragma once

#include <cuda_runtime.h>

namespace kvq {
namespace f32gemm {

// the CTA tile: 128 x 128 outputs over 32-deep slices of K
constexpr int TILE_M = 128, TILE_N = 128, TILE_K = 32;

// C (M, N) f32 = epi(op(A) @ op(B) [+ bias]) in 3xTF32: a_t, A stored (K, M)
// (the weight gradients, EPI_F32 only, through `splits` f32 partials of
// kchunk rows of K in ws, summed in a fixed order); b_t, B stored (N, K) (the
// data gradients: EPI_F32, EPI_ADD_F32, EPI_DGELU_*); neither, the forward
// (EPI_F32, EPI_GELU_*, with an optional bias). C2 receives the pre-GELU u or
// the du of a dgelu epilogue when not null; colparts (ceil(M / 128), N) and
// colsum (N,), both or neither (NT with a dgelu epilogue): colsum receives du's
// column sums. Every leading dimension a multiple of 4 (TMA's 16-byte
// strides) and at least a row's contiguous extent rounded up to 4 (what lies
// past the extent is not read: gemm_f32.cu), A and B 16-byte aligned, N and
// ldc even. Returns a cudaError_t code.
int run_gemm(int a_t, int b_t, const float* A, int lda, const float* B, int ldb, int M, int N,
             int K, int epi, int splits, int kchunk, float* C, int ldc, float* C2, int ldc2,
             const float* aux, int ld_aux, const float* bias, float* ws, float* colparts,
             float* colsum, cudaStream_t st);

// The fused head + CE's product x (rows, hidden) @ table (vocab, hidden)^T in
// 3xTF32 with a CE epilogue (gemm_f32.cu), 128 x 128 tiles, any vocab:
// EPI_CE_FWD writes the partials part_f (3, ceil(vocab / 128), rows) and
// part_i (ceil(vocab / 128), rows), and, when C is not null, the logits
// (rows, ldc) (pad columns 0); EPI_CE_BWD writes g = C (rows, ldc) from
// lse and scale (rows,) and the dbias partials part_f (ceil(rows / 128),
// vocab). hidden a multiple of 4, x and table 16-byte aligned, ldc even and
// at least vocab. Returns a cudaError_t code.
int run_ce(int epi, const float* x, const float* table, const float* bias, int rows, int vocab,
           int hidden, float* C, int ldc, const int* targets, const float* lse, const float* scale,
           float* part_f, int* part_i, cudaStream_t st);

// The VQ's distances (vq_fwd.cu's general path): C (M, N) f32 = (z - center)
// @ ec^T in 3xTF32, z (M, K) at ldz, ec (N, K) at ldk, C at N. Each element
// of z is centred by one f32 subtraction, z - center[k], as it is read for
// its split (the same value as the subtraction on the CUDA cores); center
// holds round32(K) floats, 0 past K. ldz and ldk multiples of 4 and at least
// round4(K), z and ec 16-byte aligned, N even. Every 32-deep slice of K sums
// its 96 products in a fresh accumulator that one rounded FADD adds to the
// tile's sum (vq_fwd.cu bounds the error on that). Returns a cudaError_t
// code.
int run_vq_cross(const float* z, int ldz, const float* center, const float* ec, int ldk, int M,
                 int N, int K, float* C, cudaStream_t st);

}  // namespace f32gemm
}  // namespace kvq
