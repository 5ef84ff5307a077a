// The data gradients' products of the layer GEMM (gemm_sm90.cuh): dY (M, K)
// @ W^T, W stored (N, K), with the residual add or the GELU gradient fused.

#include "gemm_sm90.cuh"

namespace kvq {
namespace sm90 {

cudaError_t launch_nt(int tile_n, int epi, const CUtensorMap& a, const CUtensorMap& b,
                      const Args& p, int sms, cudaStream_t st) {
  switch (epi) {
    case EPI_F32: return launch_tile<false, false, EPI_F32>(tile_n, a, b, p, sms, st);
    case EPI_BF16: return launch_tile<false, false, EPI_BF16>(tile_n, a, b, p, sms, st);
    case EPI_ADD_F32: return launch_tile<false, false, EPI_ADD_F32>(tile_n, a, b, p, sms, st);
    case EPI_ADD_BF16: return launch_tile<false, false, EPI_ADD_BF16>(tile_n, a, b, p, sms, st);
    case EPI_DGELU_ERF: return launch_tile<false, false, EPI_DGELU_ERF>(tile_n, a, b, p, sms, st);
    case EPI_DGELU_TANH:
      return launch_tile<false, false, EPI_DGELU_TANH>(tile_n, a, b, p, sms, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
}  // namespace kvq
