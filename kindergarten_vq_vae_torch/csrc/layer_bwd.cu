// Fused post-LN BertLayer backward for Hopper (sm_90a).
//
// Replaces kindergarten_vq_vae_tpu/ops/layer_pallas.py `_layer_bwd_kernel`
// (l.552) and, inside it, the attention backward of `_attn_bwd_self_kernel`
// / `_attn_bwd_cross_kernel` (l.696, l.712; math in `_attn_bwd_tile` l.304).
// ops/layer.py runs the backward as a sequence of entry points on one
// stream, from the residuals the training forward kept:
//
//   kvq_ln_bwd          (layernorm.cu) LayerNorm backward (`_ln_bwd` l.175)
//                       from the stored LN output and rsqrt, times the
//                       hidden-dropout mask, with the dgamma / dbeta / dbias
//                       column sums
//   kvq_gemm_sm90       (gemm_sm90.cu) dgrad (dY @ W^T, with the GELU-gradient
//                       or residual add fused into the epilogue; the GELU
//                       gradient's epilogue also gives b1's column partials)
//                       and wgrad (X^T @ dY over all rows, split-K, f32 sums
//                       rounded once to bf16)
//   kvq_attention_bwd   per-(sentence, head) attention backward with the
//                       same keep mask on dv and dp as the forward, one
//                       warp a head on mma.sync tiles (attention.cuh; past
//                       head_dim 128 attention_long.cu's 64-column chunks);
//                       past 32 tokens, up to 512, 64-row tiles on mma.sync
//                       (attention_long.cu): a launch a block a query tile
//                       for dq and the rows' statistics, then a launch a
//                       block a key tile for dk and dv
//   kvq_colsum          (layernorm.cu) f32 bias-gradient column sums
//
// In f32 (JAX's parity dtype) the same sequence runs the f32 instances:
// kvq_gemm_f32 (gemm_f32.cu, 3xTF32, the weight gradients kept in f32), the
// 3xTF32 attention backward of attention_f32.cuh, and layernorm.cu's f32 rows.
//
// What bounds it on the H100: the dgrad and wgrad GEMMs are twice the
// forward's FLOPs and compute-bound at 24576 rows (gemm_sm90.cuh says how
// the GEMM meets that); the weight gradients have few output tiles (768 x
// 768 is 24 tiles of 128 x 192) over a long reduction, so their rows are
// split into f32 partial products that fill the card and are summed in a
// fixed order. The TPU kernel carried its
// weight-gradient accumulators across a sequential grid in VMEM; blocks on
// the H100 run in no order, so every reduction across rows here is a
// deterministic two-pass sum (per-block partials, then a fixed-order sum).

#include "attention.cuh"
#include "attention_f32.cuh"
#include "dropout_hash.cuh"
#include "layer_common.cuh"

using namespace kvq;

extern "C" {

// Attention backward for batch sentences x num_heads heads. q rows at
// q + (b*s_q + i)*q_ld, k / v rows at k|v + (b*s_k + j)*kv_ld (head h at
// column h*head_dim); g (batch*s_q, H) bf16; dq / dk / dv with the same
// strides as q / k / v. key_mask (batch, s_k) int32 or null. stats: past 32
// queries or keys (at any head_dim), an f32 scratch of batch * num_heads *
// s_q * 4 (each query row's max, sum of exp z, 1 / z and t, from the dq
// launch to the dk / dv launch); else null. All f32 when f32, else bf16.
int kvq_attention_bwd(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                      const int* key_mask, const void* g, void* dq, int dq_ld, void* dk, void* dv,
                      int dkv_ld, float* stats, int batch, int num_heads, int head_dim, int s_q,
                      int s_k, int causal, unsigned seed, unsigned thresh, float scale,
                      int op_base, int f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!attention_fits(s_q, s_k, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const DropoutParams drop{seed, thresh, scale, thresh != 0u};
  if (f32)
    return attention_f32_bwd(q, q_ld, k, v, kv_ld, key_mask, g, dq, dq_ld, dk, dv, dkv_ld, batch,
                             num_heads, head_dim, s_q, s_k, causal, drop, op_base, stats, st);
  return attention_bwd(q, q_ld, k, v, kv_ld, key_mask, g, dq, dq_ld, dk, dv, dkv_ld, batch,
                       num_heads, head_dim, s_q, s_k, causal, drop, op_base, stats, st);
}

}  // extern "C"
