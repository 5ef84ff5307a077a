// Host side of the GEMM (gemm_sm90.cuh): the TMA descriptors, built per
// call (bf16 here, f32 for gemm_f32.cu), the checks, the dispatch, the
// weight gradients' split-K instantiations, and the C entry point
// kvq_gemm_sm90 behind ops/gemm.py `gemm`. The layer forward (layer_fwd.cu) and the fused head + CE
// (head_ce.cu) call run_gemm directly.

#include "gemm_sm90.cuh"
#include "layernorm.cuh"

namespace kvq {
namespace sm90 {

namespace {

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query:
// the library links against no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// a row-major (rows, cols) matrix of elem_bytes elements, 128-byte swizzle,
// elements past the matrix read as zeros
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
               int rows, int cols, int ld, int box_cols, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int ld, int box_cols,
                int box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rows, cols, ld, box_cols,
                   box_rows);
}

bool tensor_map_f32(CUtensorMap* map, const void* ptr, int rows, int cols, int ld, int box_cols,
                    int box_rows) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, rows, cols, ld, box_cols,
                   box_rows);
}

cudaError_t launch_tn(int tile_n, const CUtensorMap& a, const CUtensorMap& b, const Args& p,
                      int sms, cudaStream_t st) {
  return launch_tile<true, true, EPI_PARTIAL>(tile_n, a, b, p, sms, st);
}

int run_gemm(int a_mn, int b_mn, const void* A, int lda, const void* B, int ldb, int M, int N,
             int K, int epi, int tile_n, int splits, int kchunk, void* C, int ldc, void* C2,
             int ldc2, const void* aux, int ld_aux, const float* bias, float* ws, int sms,
             cudaStream_t st, float* colparts, float* colsum) {
  const bool shape_ok = M > 0 && N > 0 && K > 0 && sms > 0 && N % 8 == 0 && lda % 8 == 0 &&
                        ldb % 8 == 0 && tile_n > 0 && tile_n <= 256 && tile_n % 64 == 0 &&
                        splits >= 1 && kchunk > 0 && kchunk % TILE_K == 0 &&
                        (long long)splits * kchunk >= K && (long long)(splits - 1) * kchunk < K;
  const bool layout_ok = a_mn ? (b_mn && ws != nullptr && (epi == EPI_F32 || epi == EPI_BF16))
                              : splits == 1;
  const bool colsum_ok = colparts == nullptr
                             ? colsum == nullptr
                             : colsum != nullptr && !a_mn && !b_mn &&
                                   (epi == EPI_DGELU_ERF || epi == EPI_DGELU_TANH);
  if (!shape_ok || !layout_ok || !colsum_ok || !aligned16(A) || !aligned16(B))
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const bool maps = (a_mn ? tensor_map(&ma, A, K, M, lda, 64, 64)
                          : tensor_map(&ma, A, M, K, lda, 64, TILE_M)) &&
                    (b_mn ? tensor_map(&mb, B, K, N, ldb, 64, 64)
                          : tensor_map(&mb, B, N, K, ldb, 64, tile_n));
  if (!maps) return cudaErrorInvalidValue;
  Args p{M, N, K, kchunk, splits, (M + TILE_M - 1) / TILE_M, (N + tile_n - 1) / tile_n,
         C, ldc, C2, ldc2, aux, ld_aux, bias};
  p.colpart = colparts;
  if (!a_mn) {
    const cudaError_t e = b_mn ? launch_nn(tile_n, epi, ma, mb, p, sms, st)
                               : launch_nt(tile_n, epi, ma, mb, p, sms, st);
    if (e != cudaSuccess || colparts == nullptr) return static_cast<int>(e);
    return static_cast<int>(colparts_reduce(colparts, p.tiles_m, N, colsum, st));
  }
  // weight gradient: f32 partial products, then one fixed-order sum
  p.C = ws;
  p.ldc = N;
  p.C2 = nullptr;
  p.bias = nullptr;
  const cudaError_t e = launch_tn(tile_n, ma, mb, p, sms, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t total = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(ws, splits, M, N, C, ldc,
                                                                        epi == EPI_BF16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace kvq

extern "C" {

// C (M, N) = epi(op(A) @ op(B) [+ bias]): a_t, A stored (K, M) and read
// transposed (the weight gradients X^T dY, epilogue f32 or bf16, through
// `splits` f32 partials in ws); b_t, B stored (N, K) and read transposed
// (the data gradients dY W^T); neither, the forward's A @ W. C2, aux and bias
// may be null where the epilogue does not read them. colparts
// (ceil(M / 128), N) f32 scratch and colsum (N,) f32, both or neither (NT
// with a dgelu epilogue): colsum receives the f32 du's column sums. tile_n,
// splits and kchunk are ops/gemm.py `gemm_plan`'s; sms the grid's cap.
// Returns a cudaError_t code.
int kvq_gemm_sm90(int a_t, int b_t, const void* A, int lda, const void* B, int ldb, int M, int N,
                  int K, int epi, int tile_n, int splits, int kchunk, void* C, int ldc, void* C2,
                  int ldc2, const void* aux, int ld_aux, const void* bias, void* ws, int sms,
                  void* colparts, void* colsum, void* stream) {
  return kvq::sm90::run_gemm(a_t, !b_t, A, lda, B, ldb, M, N, K, epi, tile_n, splits, kchunk, C,
                             ldc, C2, ldc2, aux, ld_aux, static_cast<const float*>(bias),
                             static_cast<float*>(ws), sms, static_cast<cudaStream_t>(stream),
                             static_cast<float*>(colparts), static_cast<float*>(colsum));
}

}  // extern "C"
