// The forward's products of the layer GEMM (gemm_sm90.cuh): A (M, K) @ W (K,
// N) + bias, f32, bf16 or GELU (with the pre-GELU u) out.

#include "gemm_sm90.cuh"

namespace kvq {
namespace sm90 {

cudaError_t launch_nn(int tile_n, int epi, const CUtensorMap& a, const CUtensorMap& b,
                      const Args& p, int sms, cudaStream_t st) {
  switch (epi) {
    case EPI_F32: return launch_tile<false, true, EPI_F32>(tile_n, a, b, p, sms, st);
    case EPI_BF16: return launch_tile<false, true, EPI_BF16>(tile_n, a, b, p, sms, st);
    case EPI_GELU_ERF: return launch_tile<false, true, EPI_GELU_ERF>(tile_n, a, b, p, sms, st);
    case EPI_GELU_TANH: return launch_tile<false, true, EPI_GELU_TANH>(tile_n, a, b, p, sms, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace kvq
