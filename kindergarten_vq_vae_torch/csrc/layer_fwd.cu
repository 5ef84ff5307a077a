// Fused post-LN BertLayer forward for Hopper (sm_90a), serving and training.
//
// Replaces kindergarten_vq_vae_tpu/ops/layer_pallas.py `_layer_fwd_kernel`
// (l.489, math in `_layer_fwd_core` l.374): one whole BertLayer per call,
//
//     x1 = LN(x  + drop(Wo  @ attn(Wqkv @ x)))                  self-attention
//     x2 = LN(x1 + drop(Wco @ attn(Wq @ x1, Wkv @ enc)))         cross-attention (decoder)
//     y  = LN(xm + drop(W2  @ gelu(W1 @ xm)))                    MLP, xm = x2 or x1
//
// with the TPU kernel's rounding points: bf16 operands, f32 accumulation,
// f32 bias / LayerNorm parameters; qkv, qc, kvc, ctx, x1, x2 and the GELU
// output rounded to bf16; residual sums in f32. Dropout is the counter-based
// hash of dropout_hash.cuh: on the attention probabilities after the e / z
// softmax and before their bf16 rounding, and on each projection output
// before its residual add. In training mode the call also keeps the
// backward's residuals (qkv, ctx, ctx2, x1, x2, qc, kvc, the pre-GELU u and
// the GELU output m in bf16, and each LayerNorm's per-row rsqrt in f32).
//
// What bounds it on the H100: at 2048 sentences x 12 tokens (24576 rows) the
// projections are compute-bound GEMMs (K = 768 or 3072, N up to 3072), while
// attention (12 x 12 scores per head) and residual + LayerNorm are
// memory-bound and small. The design therefore spends its effort on the GEMM:
// bf16 tensor cores with the bias / cast / GELU fused into the epilogue, so
// no f32 intermediate of the wide MLP reaches memory.
// The TPU kernel's block-diagonal packing of sentences (`_attn_fwd_tile`)
// existed to feed the 128x128 MXU; here one CTA computes one (sentence,
// head) directly (attention.cuh), which gives the same values (off-block
// scores were -1e9, exp() sent them to exactly 0). One C call launches the
// layer's whole sequence on the caller's stream and returns cudaGetLastError().

#include "attention.cuh"
#include "dropout_hash.cuh"
#include "layer_common.cuh"

using namespace kvq;

namespace {

// C[M, N] = epi(A[M, K] @ B[K, N] + bias[N]); A, B bf16 row-major, bias f32.
// With a GELU epilogue, pre_gelu (may be null) receives bf16(A @ B + bias),
// the training residual. Requires K % 8 == 0, N % 8 == 0, 16-byte aligned
// rows (checked by the host). The backward's GEMM (layer_common.cuh) reads
// transposed operands and has its own epilogues; this kernel stays separate
// because folding it into that template measured 8% slower on the serving
// forward on an H100 80GB HBM3 at 700 W (130 registers and a spill there;
// 128 a thread here with no spills, two CTAs per SM).
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bias_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
                 const float* __restrict__ bias, void* __restrict__ C, int ldc,
                 int M, int N, int K, int epi, bf16* __restrict__ pre_gelu) {
  constexpr int A_LD = BK + 8, B_LD = BN + 8;  // padded smem rows: 16-byte aligned
  __shared__ __align__(128) bf16 As[STAGES][BM * A_LD];
  __shared__ __align__(128) bf16 Bs[STAGES][BK * B_LD];
  __shared__ __align__(128) float Cs[GEMM_THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto load_tile = [&](int stage, int k0) {
    for (int c = tid; c < BM * BK / 8; c += GEMM_THREADS) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + col;
      const bool p = gr < M && gc < K;
      cp_async16(&As[stage][r * A_LD + col], p ? A + (size_t)gr * lda + gc : A, p);
    }
    for (int c = tid; c < BK * BN / 8; c += GEMM_THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const int gr = k0 + r, gc = n0 + col;
      const bool p = gr < K && gc < N;
      cp_async16(&Bs[stage][r * B_LD + col], p ? B + (size_t)gr * ldb + gc : B, p);
    }
  };

  const int nk = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_tile((kt + 1) % STAGES, (kt + 1) * BK);
    cp_async_commit();  // possibly empty: keeps wait_group 1 meaning "tile kt has landed"
    cp_async_wait_1();
    __syncthreads();
    const bf16* as = As[kt % STAGES];
    const bf16* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * WM + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], bs + kk * B_LD + wn * WN + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: one 16x16 fragment at a time through a per-warp f32 scratch
  float* cs = Cs[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int rbase = m0 + wm * WM + i * 16, cbase = n0 + wn * WN + j * 16;
      for (int e = lane; e < 256; e += 32) {
        const int gr = rbase + e / 16, gc = cbase + e % 16;
        if (gr < M && gc < N) {
          const float u = cs[e] + bias[gc];
          const size_t o = (size_t)gr * ldc + gc;
          if (epi == EPI_F32) {
            static_cast<float*>(C)[o] = u;
          } else {
            const float v = epi == EPI_GELU_ERF ? gelu_erf(u) : epi == EPI_GELU_TANH ? gelu_tanh(u) : u;
            static_cast<bf16*>(C)[o] = __float2bfloat16(v);
            if (pre_gelu != nullptr) pre_gelu[o] = __float2bfloat16(u);
          }
        }
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------- residual + LayerNorm
constexpr int LN_THREADS = 256;

// out = LN(float(x) + drop(a)) with flax's fast variance; one warp per row.
// inv (M,) f32 receives each row's rsqrt when given.
__global__ void __launch_bounds__(LN_THREADS)
residual_layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          bf16* __restrict__ out, float* __restrict__ inv_out, int M, int N,
                          float eps, DropoutParams drop, uint32_t op) {
  const int row = blockIdx.x * (LN_THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const bf16* xr = x + (size_t)row * N;
  const float* ar = a + (size_t)row * N;
  const uint32_t rt = dropout_row_term(row, op, drop.seed);
  float s = 0.0f, s2 = 0.0f;
  for (int c = lane; c < N; c += 32) {
    const float av = drop.on ? ar[c] * dropout_keep(rt, c, drop) : ar[c];
    const float r = __bfloat162float(xr[c]) + av;
    s += r;
    s2 += r * r;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / N;
  const float var = fmaxf(s2 / N - mu * mu, 0.0f);
  const float inv = rsqrtf(var + eps);
  if (inv_out != nullptr && lane == 0) inv_out[row] = inv;
  bf16* orow = out + (size_t)row * N;
  for (int c = lane; c < N; c += 32) {
    const float av = drop.on ? ar[c] * dropout_keep(rt, c, drop) : ar[c];
    const float r = __bfloat162float(xr[c]) + av;
    orow[c] = __float2bfloat16((r - mu) * inv * gamma[c] + beta[c]);
  }
}

void gemm_nn(const void* A, int lda, const void* B, int ldb, const void* bias, void* C, int ldc,
             int M, int N, int K, int epi, cudaStream_t st, void* pre_gelu = nullptr) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bias_kernel<<<grid, GEMM_THREADS, 0, st>>>(
      static_cast<const bf16*>(A), lda, static_cast<const bf16*>(B), ldb,
      static_cast<const float*>(bias), C, ldc, M, N, K, epi, static_cast<bf16*>(pre_gelu));
}

void residual_layernorm(const void* x, const void* a, const void* g, const void* be, void* out,
                        float* inv, int M, int N, float eps, DropoutParams drop, uint32_t op,
                        cudaStream_t st) {
  const int rows_per_block = LN_THREADS / 32;
  residual_layernorm_kernel<<<(M + rows_per_block - 1) / rows_per_block, LN_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(g),
      static_cast<const float*>(be), static_cast<bf16*>(out), inv, M, N, eps, drop, op);
}

}  // namespace

extern "C" {

const char* kvq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One post-LN BertLayer forward. x (batch*s_q, H) bf16; enc (batch*s_k, H)
// bf16 or null; smask (batch, s_q) / cmask (batch, s_k) int32 or null.
// Weights: w* bf16 (in, out); b*, g*, be* f32. Workspace (all written):
// qkv (M, 3H), ctx (M, H), acc f32 (M, H), x1 (M, H), m (M, F); decoder also
// qc (M, H), kvc (batch*s_k, 2H), x2 (M, H). ctx2 (M, H) receives the
// cross-attention context when given (else it reuses ctx). Training
// residuals, when given: u (M, F) bf16, invs (3, M) f32 (rows 0 / 1 / 2:
// the LayerNorm rsqrt after self-attention / cross-attention / MLP).
// out (M, H) bf16. Dropout: seed is the int32 seed's bits; a zero
// threshold (rate 0) switches a site off.
int kvq_bert_layer_fwd(const void* x, const void* enc, const int* smask, const int* cmask,
                       const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                       const void* g1, const void* be1, const void* wq, const void* bq,
                       const void* wkv, const void* bkv, const void* wco, const void* bco,
                       const void* g2, const void* be2, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* g3, const void* be3,
                       void* qkv, void* ctx, void* ctx2, void* acc, void* x1, void* qc, void* kvc,
                       void* x2, void* m, void* u, void* invs, void* out, int batch, int s_q,
                       int s_k, int num_heads, int head_dim, int intermediate, int causal,
                       int has_cross, int gelu_exact, float eps, unsigned seed,
                       unsigned attn_thresh, float attn_scale, unsigned hid_thresh,
                       float hid_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = num_heads * head_dim, F = intermediate, M = batch * s_q;
  const DropoutParams attn_drop{seed, attn_thresh, attn_scale, attn_thresh != 0u};
  const DropoutParams hid_drop{seed, hid_thresh, hid_scale, hid_thresh != 0u};
  float* inv = static_cast<float*>(invs);

  // self-attention block
  gemm_nn(x, H, wqkv, 3 * H, bqkv, qkv, 3 * H, M, 3 * H, H, EPI_BF16, st);
  const bf16* qkv_b = static_cast<const bf16*>(qkv);
  attention(qkv_b, 3 * H, qkv_b + H, qkv_b + 2 * H, 3 * H, smask, ctx, H, batch, num_heads,
            head_dim, s_q, s_q, causal, attn_drop, 0, st);
  gemm_nn(ctx, H, wo, H, bo, acc, H, M, H, H, EPI_F32, st);
  residual_layernorm(x, acc, g1, be1, x1, inv, M, H, eps, hid_drop, OP_ATTN_OUT, st);

  const void* xm = x1;
  if (has_cross) {
    void* c2 = ctx2 != nullptr ? ctx2 : ctx;
    gemm_nn(x1, H, wq, H, bq, qc, H, M, H, H, EPI_BF16, st);
    gemm_nn(enc, H, wkv, 2 * H, bkv, kvc, 2 * H, batch * s_k, 2 * H, H, EPI_BF16, st);
    const bf16* kvc_b = static_cast<const bf16*>(kvc);
    attention(qc, H, kvc_b, kvc_b + H, 2 * H, cmask, c2, H, batch, num_heads, head_dim, s_q,
              s_k, 0, attn_drop, num_heads + 1, st);
    gemm_nn(c2, H, wco, H, bco, acc, H, M, H, H, EPI_F32, st);
    residual_layernorm(x1, acc, g2, be2, x2, inv ? inv + M : nullptr, M, H, eps, hid_drop,
                       OP_CROSS_OUT, st);
    xm = x2;
  }

  // MLP block
  gemm_nn(xm, H, w1, F, b1, m, F, M, F, H, gelu_exact ? EPI_GELU_ERF : EPI_GELU_TANH, st, u);
  gemm_nn(m, F, w2, H, b2, acc, H, M, H, F, EPI_F32, st);
  residual_layernorm(xm, acc, g3, be3, out, inv ? inv + 2 * M : nullptr, M, H, eps, hid_drop,
                     OP_MLP_OUT, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
