// Standalone attention for the per-module BERT trunk (fused_layer off), on
// Hopper (sm_90a): the C entry points of three TPU kernels over the device
// code the layer kernels use (attention.cuh).
//
//   kvq_sdpa_fwd   kindergarten_vq_vae_tpu/ops/sdpa_pallas.py `_sdpa_fwd_kernel`
//                  (l.103, #11): block-diagonal SDPA with an additive NEG_INF
//                  key / causal mask and hash dropout on p (op id = head)
//   kvq_sdpa_bwd   `_sdpa_bwd_kernel` (l.142, #12): dq, dk, dv, recomputing p
//                  from q and k and rebuilding the same keep mask
//   kvq_mha_fwd    ops/attention_pallas.py `_mha_kernel` (l.65, #13): no
//                  dropout, masked scores replaced by NEG_INF, p = e * (1/z)
//
// q, k and v are read at their own row strides, so the split views of a
// packed qkv (row 3H) or kv (row 2H) go in without a copy; the gradients are
// written at their own strides too. The TPU kernels' sentence tile
// (`block_b`) fed the MXU and has no counterpart: one warp computes one
// (sentence, head) on mma.sync tiles, over a persistent grid, with 16-byte
// staged loads and stores where the strides allow (attention.cuh; past
// head_dim 128 attention_long.cu's 64-column chunks); past 32 tokens, up to
// 512, 64-row tiles of queries and keys on mma.sync, a block a tile, the
// backward in two launches (attention_long.cu). What
// bounds them on the H100 is the bytes; the dropout hash is
// dropout_hash.cuh's, keyed on the absolute query row, the key position
// within the sentence, the head and the seed, as `_dropout_keep_scale`
// (sdpa_pallas.py:77) keys it.
//
// With f32 set (JAX's parity dtype: every operand and output f32) each entry
// runs attention_f32.cuh instead: 3xTF32 mma.sync, a warp a (sentence,
// head), the same keep-mask ids (op base 0), and for #13 its WHERE_MASK instance.

#include "attention.cuh"
#include "attention_f32.cuh"
#include "dropout_hash.cuh"

using namespace kvq;

extern "C" {

// out (batch*s_q rows at out_ld) = attention of q (rows at q_ld) over k / v
// (rows at kv_ld); key_mask (batch, s_k) int32 or null; dropout from the
// seed's bits, threshold and scale (a zero threshold switches it off). All
// f32 when f32, else bf16.
int kvq_sdpa_fwd(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                 const int* key_mask, void* out, int out_ld, int batch, int num_heads,
                 int head_dim, int s_q, int s_k, int causal, unsigned seed, unsigned thresh,
                 float scale, int f32, void* stream) {
  if (!attention_fits(s_q, s_k, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const DropoutParams drop{seed, thresh, scale, thresh != 0u};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return attention_f32(q, q_ld, k, v, kv_ld, key_mask, out, out_ld, batch, num_heads, head_dim,
                         s_q, s_k, causal, drop, 0, st);
  return attention<false>(q, q_ld, k, v, kv_ld, key_mask, out, out_ld, batch, num_heads,
                          head_dim, s_q, s_k, causal, drop, 0, st);
}

// dq (rows at dq_ld), dk and dv (rows at dkv_ld) of kvq_sdpa_fwd's output,
// given its gradient g (batch*s_q contiguous rows of num_heads*head_dim);
// stats: past 32 queries or keys (at any head_dim) the f32 scratch of
// kvq_attention_bwd (layer_bwd.cu), else null.
int kvq_sdpa_bwd(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                 const int* key_mask, const void* g, void* dq, int dq_ld, void* dk, void* dv,
                 int dkv_ld, float* stats, int batch, int num_heads, int head_dim, int s_q,
                 int s_k, int causal, unsigned seed, unsigned thresh, float scale, int f32,
                 void* stream) {
  if (!attention_fits(s_q, s_k, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const DropoutParams drop{seed, thresh, scale, thresh != 0u};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return attention_f32_bwd(q, q_ld, k, v, kv_ld, key_mask, g, dq, dq_ld, dk, dv, dkv_ld, batch,
                             num_heads, head_dim, s_q, s_k, causal, drop, 0, stats, st);
  return attention_bwd(q, q_ld, k, v, kv_ld, key_mask, g, dq, dq_ld, dk, dv, dkv_ld, batch,
                       num_heads, head_dim, s_q, s_k, causal, drop, 0, stats, st);
}

// out = the #13 attention of q over k / v (one sequence length s for both).
int kvq_mha_fwd(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                const int* key_mask, void* out, int out_ld, int batch, int num_heads,
                int head_dim, int s, int causal, int f32, void* stream) {
  if (!attention_fits(s, s, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const DropoutParams off{0u, 0u, 1.0f, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32)
    return attention_f32<true>(q, q_ld, k, v, kv_ld, key_mask, out, out_ld, batch, num_heads,
                               head_dim, s, s, causal, off, 0, st);
  return attention<true>(q, q_ld, k, v, kv_ld, key_mask, out, out_ld, batch, num_heads, head_dim,
                         s, s, causal, off, 0, st);
}

}  // extern "C"
