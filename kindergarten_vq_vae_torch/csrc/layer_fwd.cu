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
// the wgmma + TMA layer GEMM of gemm_sm90.cuh with the bias / cast / GELU
// fused into its epilogue, so no f32 intermediate of the wide MLP reaches
// memory.
// The TPU kernel's block-diagonal packing of sentences (`_attn_fwd_tile`)
// existed to feed the 128x128 MXU; here one warp computes one (sentence,
// head) directly on mma.sync tiles (attention.cuh), which gives the same
// values (off-block scores were -1e9, exp() sent them to exactly 0; past
// head_dim 128 over attention_long.cu's 64-column chunks); past 32 tokens,
// up to 512, a block takes 64 query rows of a (sentence, head) on mma.sync
// tiles (attention_long.cu). Each
// residual + LayerNorm is layernorm.cu's one-pass kernel (a warp a row in
// registers, 16-byte accesses; past 1,024 columns a block a row). One C
// call launches the layer's whole sequence on the caller's stream and
// returns cudaGetLastError(); kvq_attention_fwd launches its attention alone.
//
// In f32 (JAX's parity dtype, in which the TPU kernel runs too) the same
// sequence runs the f32 instances: the 3xTF32 GEMM of gemm_f32.cu, the 3xTF32
// attention of attention_f32.cuh and layernorm.cu's f32 rows; every bf16
// intermediate above is then f32, and the roundings to it are identities.

#include "attention.cuh"
#include "attention_f32.cuh"
#include "dropout_hash.cuh"
#include "gemm_f32.cuh"
#include "gemm_sm90.cuh"
#include "layer_common.cuh"
#include "layernorm.cuh"

using namespace kvq;

namespace {

// C[M, N] = epi(A[M, K] @ B[K, N] + bias[N]) through the layer GEMM
// (gemm_sm90.cuh) on a tile_n-wide tile; with a GELU epilogue, pre_gelu (may
// be null) receives bf16(A @ B + bias), the training residual.
// In f32 the f32 GEMM, whose every output is f32 (EPI_BF16 becomes EPI_F32).
int gemm_nn(bool f32, const void* A, int lda, const void* B, int ldb, const void* bias, void* C,
            int ldc, int M, int N, int K, int epi, int tile_n, int sms, cudaStream_t st,
            void* pre_gelu = nullptr) {
  if (f32)
    return f32gemm::run_gemm(0, 0, static_cast<const float*>(A), lda,
                             static_cast<const float*>(B), ldb, M, N, K,
                             epi == EPI_BF16 ? EPI_F32 : epi, 1, K, static_cast<float*>(C), ldc,
                             static_cast<float*>(pre_gelu), ldc, nullptr, 0,
                             static_cast<const float*>(bias), nullptr, nullptr, nullptr, st);
  const int kchunk = (K + sm90::TILE_K - 1) / sm90::TILE_K * sm90::TILE_K;
  return sm90::run_gemm(0, 1, A, lda, B, ldb, M, N, K, epi, tile_n, 1, kchunk, C, ldc, pre_gelu,
                        ldc, nullptr, 0, static_cast<const float*>(bias), nullptr, sms, st);
}

// the attention of attention.cuh (bf16) or attention_f32.cuh (f32)
int attend(bool f32, const void* q, int q_ld, const void* k, const void* v, int kv_ld,
           const int* mask, void* ctx, int ctx_ld, int batch, int nh, int hd, int s_q, int s_k,
           int causal, DropoutParams drop, int op_base, cudaStream_t st) {
  if (f32)
    return attention_f32(q, q_ld, k, v, kv_ld, mask, ctx, ctx_ld, batch, nh, hd, s_q, s_k,
                         causal, drop, op_base, st);
  return attention(q, q_ld, k, v, kv_ld, mask, ctx, ctx_ld, batch, nh, hd, s_q, s_k, causal, drop,
                   op_base, st);
}

}  // namespace

extern "C" {

const char* kvq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One post-LN BertLayer forward. x (batch*s_q, H) in the compute dtype (f32
// when f32, else bf16); enc (batch*s_k, H) in it or null; smask (batch, s_q)
// / cmask (batch, s_k) int32 or null. Weights: w* in the compute dtype (in,
// out); b*, g*, be* f32. Workspace (all written, in the compute dtype but
// acc): qkv (M, 3H), ctx (M, H), acc f32 (M, H), x1 (M, H), m (M, F);
// decoder also qc (M, H), kvc (batch*s_k, 2H), x2 (M, H). ctx2 (M, H)
// receives the cross-attention context when given (else it reuses ctx).
// Training residuals, when given: u (M, F), invs (3, M) f32 (rows 0 / 1 /
// 2: the LayerNorm rsqrt after self-attention / cross-attention / MLP).
// out (M, H). Dropout: seed is the int32 seed's bits; a zero threshold
// (rate 0) switches a site off. tile_n (7 ints): the bf16 GEMM's tile width
// of the products qkv, wo, wq, wkv, wco, w1, w2 (ops/gemm.py `gemm_plan`;
// the f32 GEMM's tile is fixed); sms caps the bf16 GEMMs' persistent grids.
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
                       float hid_scale, const int* tile_n, int sms, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int H = num_heads * head_dim, F = intermediate, M = batch * s_q;
  const DropoutParams attn_drop{seed, attn_thresh, attn_scale, attn_thresh != 0u};
  const DropoutParams hid_drop{seed, hid_thresh, hid_scale, hid_thresh != 0u};
  float* inv = static_cast<float*>(invs);
  const bool fp = f32 != 0;
  const size_t es = fp ? 4 : 2;  // bytes an element of the compute dtype
  auto at = [es](const void* p, int elems) { return static_cast<const char*>(p) + elems * es; };

  int e;
#define KVQ_TRY(call) \
  if ((e = (call)) != 0) return e

  // self-attention block
  KVQ_TRY(gemm_nn(fp, x, H, wqkv, 3 * H, bqkv, qkv, 3 * H, M, 3 * H, H, EPI_BF16, tile_n[0], sms,
                  st));
  KVQ_TRY(attend(fp, qkv, 3 * H, at(qkv, H), at(qkv, 2 * H), 3 * H, smask, ctx, H, batch,
                 num_heads, head_dim, s_q, s_q, causal, attn_drop, 0, st));
  KVQ_TRY(gemm_nn(fp, ctx, H, wo, H, bo, acc, H, M, H, H, EPI_F32, tile_n[1], sms, st));
  KVQ_TRY(residual_layernorm(x, acc, g1, be1, x1, inv, M, H, eps, hid_drop, OP_ATTN_OUT, fp, st));

  const void* xm = x1;
  if (has_cross) {
    void* c2 = ctx2 != nullptr ? ctx2 : ctx;
    KVQ_TRY(gemm_nn(fp, x1, H, wq, H, bq, qc, H, M, H, H, EPI_BF16, tile_n[2], sms, st));
    KVQ_TRY(gemm_nn(fp, enc, H, wkv, 2 * H, bkv, kvc, 2 * H, batch * s_k, 2 * H, H, EPI_BF16,
                    tile_n[3], sms, st));
    KVQ_TRY(attend(fp, qc, H, kvc, at(kvc, H), 2 * H, cmask, c2, H, batch, num_heads, head_dim,
                   s_q, s_k, 0, attn_drop, num_heads + 1, st));
    KVQ_TRY(gemm_nn(fp, c2, H, wco, H, bco, acc, H, M, H, H, EPI_F32, tile_n[4], sms, st));
    KVQ_TRY(residual_layernorm(x1, acc, g2, be2, x2, inv ? inv + M : nullptr, M, H, eps,
                               hid_drop, OP_CROSS_OUT, fp, st));
    xm = x2;
  }

  // MLP block
  KVQ_TRY(gemm_nn(fp, xm, H, w1, F, b1, m, F, M, F, H, gelu_exact ? EPI_GELU_ERF : EPI_GELU_TANH,
                  tile_n[5], sms, st, u));
  KVQ_TRY(gemm_nn(fp, m, F, w2, H, b2, acc, H, M, H, F, EPI_F32, tile_n[6], sms, st));
  KVQ_TRY(residual_layernorm(xm, acc, g3, be3, out, inv ? inv + 2 * M : nullptr, M, H, eps,
                             hid_drop, OP_MLP_OUT, fp, st));
#undef KVQ_TRY
  return static_cast<int>(cudaGetLastError());
}

// The attention of the layer forward alone, self or cross, as the call above
// launches it: ctx (batch*s_q rows at ctx_ld) of q (rows at q_ld, head h at
// column h*head_dim) over k / v (rows at kv_ld); key_mask (batch, s_k) int32
// or null; head h drops with op id op_base + h (0 for self-attention,
// num_heads + 1 for cross-attention). All f32 when f32, else bf16.
int kvq_attention_fwd(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                      const int* key_mask, void* ctx, int ctx_ld, int batch, int num_heads,
                      int head_dim, int s_q, int s_k, int causal, unsigned seed, unsigned thresh,
                      float scale, int op_base, int f32, void* stream) {
  if (!attention_fits(s_q, s_k, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const DropoutParams drop{seed, thresh, scale, thresh != 0u};
  return attend(f32 != 0, q, q_ld, k, v, kv_ld, key_mask, ctx, ctx_ld, batch, num_heads,
                head_dim, s_q, s_k, causal, drop, op_base, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
