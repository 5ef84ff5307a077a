// Fused post-LN BertLayer backward for Hopper (sm_90a).
//
// Replaces kindergarten_vq_vae_tpu/ops/layer_pallas.py `_layer_bwd_kernel`
// (l.552) and, inside it, the attention backward of `_attn_bwd_self_kernel`
// / `_attn_bwd_cross_kernel` (l.696, l.712; math in `_attn_bwd_tile` l.304).
// ops/layer.py runs the backward as a sequence of the entry points below on
// one stream, from the residuals the training forward kept:
//
//   kvq_ln_bwd          LayerNorm backward (`_ln_bwd` l.175) from the stored
//                       LN output and rsqrt, times the hidden-dropout mask,
//                       with the dgamma / dbeta / dbias column sums
//   kvq_gemm_sm90       (gemm_sm90.cu) dgrad (dY @ W^T, with the GELU-gradient
//                       or residual add fused into the epilogue) and wgrad
//                       (X^T @ dY over all rows, split-K, f32 sums rounded
//                       once to bf16)
//   kvq_attention_bwd   per-(sentence, head) attention backward with the
//                       same keep mask on dv and dp as the forward, one
//                       warp a head on mma.sync tiles (attention.cuh)
//   kvq_colsum          f32 bias-gradient column sums
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
#include "dropout_hash.cuh"
#include "layer_common.cuh"

using namespace kvq;

namespace {

// ------------------------------------------------- LayerNorm backward
constexpr int LNB_THREADS = 256, LNB_ROWS = 32;

// Rows [blockIdx.x * LNB_ROWS, +LNB_ROWS). gy (M, N) f32 or bf16 upstream;
// v the stored LN output (M, N) bf16, yhat = (v - beta) / gamma (0 where
// gamma is 0); inv (M,) the forward's rsqrt. dr (M, N) f32 (optional) =
// inv * (dyhat - mean(dyhat) - yhat * mean(dyhat * yhat)), dyhat = gy*gamma;
// da (M, N) bf16 = dr * keep. parts (gridDim.x, 3, N): per-block column sums
// of gy * yhat, gy and dr * keep (f32, before rounding).
__global__ void __launch_bounds__(LNB_THREADS)
ln_bwd_kernel(const void* __restrict__ gy, int gy_f32, const bf16* __restrict__ v,
              const float* __restrict__ inv, const float* __restrict__ gamma,
              const float* __restrict__ beta, DropoutParams drop, uint32_t op,
              float* __restrict__ dr, bf16* __restrict__ da, float* __restrict__ parts, int M,
              int N) {
  __shared__ float m1s[LNB_ROWS], m2s[LNB_ROWS];
  const int r0 = blockIdx.x * LNB_ROWS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto up = [&](size_t o) -> float {
    return gy_f32 ? static_cast<const float*>(gy)[o]
                  : __bfloat162float(static_cast<const bf16*>(gy)[o]);
  };
  auto yhat = [&](size_t o, int c) -> float {
    const float g = gamma[c];
    return g == 0.0f ? 0.0f : (__bfloat162float(v[o]) - beta[c]) / g;
  };

  // pass 1: per-row means, one warp per row
  for (int rr = warp; rr < LNB_ROWS; rr += LNB_THREADS / 32) {
    const int row = r0 + rr;
    float s1 = 0.0f, s2 = 0.0f;
    if (row < M) {
      for (int c = lane; c < N; c += 32) {
        const size_t o = (size_t)row * N + c;
        const float dyh = up(o) * gamma[c];
        s1 += dyh;
        s2 += dyh * yhat(o, c);
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      m1s[rr] = s1 / N;
      m2s[rr] = s2 / N;
    }
  }
  __syncthreads();

  // pass 2: one thread per column over the block's rows
  for (int c = tid; c < N; c += LNB_THREADS) {
    float sgy = 0.0f, sg = 0.0f, sa = 0.0f;
    const float g = gamma[c];
    for (int rr = 0; rr < LNB_ROWS; ++rr) {
      const int row = r0 + rr;
      if (row >= M) break;
      const size_t o = (size_t)row * N + c;
      const float gu = up(o), yh = yhat(o, c);
      const float d = inv[row] * (gu * g - m1s[rr] - yh * m2s[rr]);
      float a = d;
      if (drop.on) a *= dropout_keep(dropout_row_term(row, op, drop.seed), c, drop);
      if (dr != nullptr) dr[o] = d;
      da[o] = __float2bfloat16(a);
      sgy += gu * yh;
      sg += gu;
      sa += a;
    }
    float* p = parts + (size_t)blockIdx.x * 3 * N;
    p[c] = sgy;
    p[N + c] = sg;
    p[2 * N + c] = sa;
  }
}

// out[k, c] = sum over b of parts[b, k, c] (k < nvec), in a fixed order.
__global__ void parts_reduce_kernel(const float* __restrict__ parts, int nparts, int nvec, int N,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nvec * N) return;
  float s = 0.0f;
  for (int b = 0; b < nparts; ++b) s += parts[(size_t)b * nvec * N + i];
  out[i] = s;
}

// ------------------------------------------------------ column sums
constexpr int CS_THREADS = 256, CS_ROWS = 256;

__global__ void __launch_bounds__(CS_THREADS)
colsum_kernel(const void* __restrict__ src, int src_f32, int ld, int M, int N,
              float* __restrict__ parts) {
  const int c = blockIdx.x * CS_THREADS + threadIdx.x;
  if (c >= N) return;
  const int r0 = blockIdx.y * CS_ROWS, r1 = min(M, r0 + CS_ROWS);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const size_t o = (size_t)r * ld + c;
    s += src_f32 ? static_cast<const float*>(src)[o]
                 : __bfloat162float(static_cast<const bf16*>(src)[o]);
  }
  parts[(size_t)blockIdx.y * N + c] = s;
}

}  // namespace

extern "C" {

// LayerNorm backward of M rows of width N (see ln_bwd_kernel). parts
// (ceil(M / 32), 3, N) f32 scratch; sums (3, N) f32 receives
// [sum gy * yhat, sum gy, sum dr * keep].
int kvq_ln_bwd(const void* gy, int gy_f32, const void* v, const void* inv, const void* gamma,
               const void* beta, unsigned seed, unsigned thresh, float scale, unsigned op,
               void* dr, void* da, void* parts, void* sums, int M, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropoutParams drop{seed, thresh, scale, thresh != 0u};
  const int nparts = (M + LNB_ROWS - 1) / LNB_ROWS;
  ln_bwd_kernel<<<nparts, LNB_THREADS, 0, st>>>(
      gy, gy_f32, static_cast<const bf16*>(v), static_cast<const float*>(inv),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), drop, op,
      static_cast<float*>(dr), static_cast<bf16*>(da), static_cast<float*>(parts), M, N);
  parts_reduce_kernel<<<(3 * N + 255) / 256, 256, 0, st>>>(static_cast<const float*>(parts),
                                                           nparts, 3, N,
                                                           static_cast<float*>(sums));
  return static_cast<int>(cudaGetLastError());
}

// out (N,) f32 = column sums of src (M rows of width N, row stride ld; f32
// or bf16). parts (ceil(M / 256), N) f32 scratch.
int kvq_colsum(const void* src, int src_f32, int ld, int M, int N, void* parts, void* out,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nparts = (M + CS_ROWS - 1) / CS_ROWS;
  dim3 grid((N + CS_THREADS - 1) / CS_THREADS, nparts);
  colsum_kernel<<<grid, CS_THREADS, 0, st>>>(src, src_f32, ld, M, N, static_cast<float*>(parts));
  parts_reduce_kernel<<<(N + 255) / 256, 256, 0, st>>>(static_cast<const float*>(parts), nparts,
                                                       1, N, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Attention backward for batch sentences x num_heads heads. q rows at
// q + (b*s_q + i)*q_ld, k / v rows at k|v + (b*s_k + j)*kv_ld (head h at
// column h*head_dim); g (batch*s_q, H) bf16; dq / dk / dv with the same
// strides as q / k / v. key_mask (batch, s_k) int32 or null.
int kvq_attention_bwd(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                      const int* key_mask, const void* g, void* dq, int dq_ld, void* dk, void* dv,
                      int dkv_ld, int batch, int num_heads, int head_dim, int s_q, int s_k,
                      int causal, unsigned seed, unsigned thresh, float scale, int op_base,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!attention_fits(s_q, s_k, head_dim)) return static_cast<int>(cudaErrorInvalidValue);
  const DropoutParams drop{seed, thresh, scale, thresh != 0u};
  return attention_bwd(q, q_ld, k, v, kv_ld, key_mask, g, dq, dq_ld, dk, dv, dkv_ld, batch,
                       num_heads, head_dim, s_q, s_k, causal, drop, op_base, st);
}

}  // extern "C"
