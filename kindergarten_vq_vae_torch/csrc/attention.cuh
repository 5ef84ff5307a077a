// Per-(sentence, head) attention for Hopper (sm_90a), forward and backward:
// the one implementation behind the layer kernels (layer_fwd.cu: #1 forward;
// layer_bwd.cu: #3 / #4 inside #2) and the standalone attention kernels
// (sdpa.cu: #11, #12, #13).
//
// The TPU kernels packed a tile of sentences into (rows, H) and computed
// dense block-diagonal (rows x rows) scores per head (`_sdpa_fwd_kernel`,
// ops/sdpa_pallas.py:103; `_attn_fwd_tile`, ops/layer_pallas.py), because the
// 128x128 MXU wants large products; off-block scores were -1e9 and exp() sent
// them to exactly 0. Here one CTA computes one (sentence, head) directly,
// which gives the same values without the wasted off-block work: q, k, v of
// the head are staged in shared memory (S <= 32, head_dim <= 128), the
// scores are warp dot products, the softmax runs per query row in f32.
// What bounds it on the H100: the bytes (a 12 x 12 head does ~20 KFLOP on
// ~4.6 KB); the scalar bf16 loads keep it well above that bound today.
//
// Rounding points (those of the TPU kernels): f32 scores, p = e / z in f32,
// the hash-dropout keep mask (dropout_hash.cuh) applied to p after the
// softmax, p rounded to bf16 before p @ v, f32 sums, bf16 outputs. The
// backward recomputes p from q and k and rounds ds to bf16 before dq / dk.
#pragma once

#include "dropout_hash.cuh"
#include "layer_common.cuh"

// Internal linkage in the including file's own anonymous namespace (an
// anonymous namespace nested in kvq is ambiguous in nvcc's host stubs).
namespace {

using namespace kvq;

constexpr int ATT_MAX_S = 32, ATT_MAX_HD = 128, ATT_THREADS = 128;
constexpr float NEG_INF = -1e9f;  // finite, as sdpa_pallas.py NEG_INF

// One CTA per (sentence, head). q rows live at q + (b*s_q + i)*q_ld + h*hd,
// k / v rows at k|v + (b*s_k + j)*kv_ld + h*hd. key_mask (b, s_k) int32 or
// null (all keys valid). ctx (b*s_q, nh*hd) bf16. Head h drops with op id
// op_base + h.
//
// WHERE_MASK (#13, attention_pallas.py `_mha_kernel` l.65): a masked or
// causal score is replaced by NEG_INF instead of having NEG_INF added to it
// (l.95-101), p = e * (1 / z) (l.113-118), and there is no dropout. A fully
// masked row is then uniform over all keys.
template <bool WHERE_MASK>
__global__ void __launch_bounds__(ATT_THREADS)
attention_kernel(const bf16* __restrict__ q, int q_ld, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, int kv_ld, const int* __restrict__ key_mask,
                 bf16* __restrict__ ctx, int ctx_ld, int nh, int hd, int s_q, int s_k,
                 int causal, float scale, DropoutParams drop, int op_base) {
  __shared__ bf16 qs[ATT_MAX_S * ATT_MAX_HD];
  __shared__ bf16 ks[ATT_MAX_S * ATT_MAX_HD];
  __shared__ bf16 vs[ATT_MAX_S * ATT_MAX_HD];
  __shared__ float ps[ATT_MAX_S][ATT_MAX_S + 1];

  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < s_q * hd; e += ATT_THREADS) {
    const int i = e / hd, d = e % hd;
    qs[e] = q[(size_t)(b * s_q + i) * q_ld + h * hd + d];
  }
  for (int e = tid; e < s_k * hd; e += ATT_THREADS) {
    const int j = e / hd, d = e % hd;
    const size_t o = (size_t)(b * s_k + j) * kv_ld + h * hd + d;
    ks[e] = k[o];
    vs[e] = v[o];
  }
  __syncthreads();

  // scores: one warp per (i, j), lanes across the head dimension
  for (int p = warp; p < s_q * s_k; p += ATT_THREADS / 32) {
    const int i = p / s_k, j = p % s_k;
    float s = 0.0f;
    for (int d = lane; d < hd; d += 32)
      s += __bfloat162float(qs[i * hd + d]) * __bfloat162float(ks[j * hd + d]);
    s = warp_sum(s);
    if (lane == 0) {
      bool ok = key_mask == nullptr || key_mask[b * s_k + j] > 0;
      if (causal && j > i) ok = false;
      if constexpr (WHERE_MASK)
        ps[i][j] = ok ? s * scale : NEG_INF;
      else
        ps[i][j] = s * scale + (ok ? 0.0f : NEG_INF);
    }
  }
  __syncthreads();

  // softmax as e / z in f32, times the keep mask; p rounded to bf16 before p @ v
  for (int i = tid; i < s_q; i += ATT_THREADS) {
    float m = ps[i][0];
    for (int j = 1; j < s_k; ++j) m = fmaxf(m, ps[i][j]);
    float z = 0.0f;
    for (int j = 0; j < s_k; ++j) {
      const float e = expf(ps[i][j] - m);
      ps[i][j] = e;
      z += e;
    }
    if constexpr (WHERE_MASK) {
      const float inv_z = 1.0f / z;
      for (int j = 0; j < s_k; ++j) ps[i][j] = bf16_round(ps[i][j] * inv_z);
    } else {
      const uint32_t rt = dropout_row_term(b * s_q + i, op_base + h, drop.seed);
      for (int j = 0; j < s_k; ++j) {
        float p = ps[i][j] / z;
        if (drop.on) p *= dropout_keep(rt, j, drop);
        ps[i][j] = bf16_round(p);
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < s_q * hd; e += ATT_THREADS) {
    const int i = e / hd, d = e % hd;
    float acc = 0.0f;
    for (int j = 0; j < s_k; ++j) acc += ps[i][j] * __bfloat162float(vs[j * hd + d]);
    ctx[(size_t)(b * s_q + i) * ctx_ld + h * hd + d] = __float2bfloat16(acc);
  }
}

// One CTA per (sentence, head), recomputing the probabilities from q and k:
//   p = softmax(q k^T * scale + bias), kappa = keep mask (op_base + h)
//   dv = bf16(p * kappa)^T g;  dp = (g v^T) * kappa;  t = rowsum(dp * p)
//   ds = bf16(p * (dp - t) * scale);  dq = ds k;  dk = ds^T q
// with g the context gradient (bf16, rows of nh*hd), every product
// accumulated in f32 and dq, dk, dv written in bf16 (as `_attn_bwd_call`
// and `_sdpa_bwd_kernel` return them).
// (a template, so that a file that does not launch it compiles none of it)
template <int UNUSED = 0>
__global__ void __launch_bounds__(ATT_THREADS)
attention_bwd_kernel(const bf16* __restrict__ q, int q_ld, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, int kv_ld, const int* __restrict__ key_mask,
                     const bf16* __restrict__ g, bf16* __restrict__ dq, int dq_ld,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int dkv_ld, int nh, int hd,
                     int s_q, int s_k, int causal, float scale, DropoutParams drop, int op_base) {
  __shared__ bf16 qs[ATT_MAX_S * ATT_MAX_HD];
  __shared__ bf16 ks[ATT_MAX_S * ATT_MAX_HD];
  __shared__ bf16 vs[ATT_MAX_S * ATT_MAX_HD];
  __shared__ bf16 gs[ATT_MAX_S * ATT_MAX_HD];
  __shared__ float ps[ATT_MAX_S][ATT_MAX_S + 1];
  __shared__ float dss[ATT_MAX_S][ATT_MAX_S + 1];

  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = nh * hd;
  const uint32_t op = op_base + h;

  for (int e = tid; e < s_q * hd; e += ATT_THREADS) {
    const int i = e / hd, d = e % hd;
    qs[e] = q[(size_t)(b * s_q + i) * q_ld + h * hd + d];
    gs[e] = g[(size_t)(b * s_q + i) * H + h * hd + d];
  }
  for (int e = tid; e < s_k * hd; e += ATT_THREADS) {
    const int j = e / hd, d = e % hd;
    const size_t o = (size_t)(b * s_k + j) * kv_ld + h * hd + d;
    ks[e] = k[o];
    vs[e] = v[o];
  }
  __syncthreads();

  // scores and g v^T: one warp per (i, j)
  for (int p = warp; p < s_q * s_k; p += ATT_THREADS / 32) {
    const int i = p / s_k, j = p % s_k;
    float s = 0.0f, gv = 0.0f;
    for (int d = lane; d < hd; d += 32) {
      s += __bfloat162float(qs[i * hd + d]) * __bfloat162float(ks[j * hd + d]);
      gv += __bfloat162float(gs[i * hd + d]) * __bfloat162float(vs[j * hd + d]);
    }
    s = warp_sum(s);
    gv = warp_sum(gv);
    if (lane == 0) {
      bool ok = key_mask == nullptr || key_mask[b * s_k + j] > 0;
      if (causal && j > i) ok = false;
      ps[i][j] = s * scale + (ok ? 0.0f : NEG_INF);
      dss[i][j] = gv;
    }
  }
  __syncthreads();

  // per query row: softmax, dp, t, ds; ps becomes bf16(p * kappa) for dv
  for (int i = tid; i < s_q; i += ATT_THREADS) {
    float m = ps[i][0];
    for (int j = 1; j < s_k; ++j) m = fmaxf(m, ps[i][j]);
    float z = 0.0f;
    for (int j = 0; j < s_k; ++j) {
      const float e = expf(ps[i][j] - m);
      ps[i][j] = e;
      z += e;
    }
    const uint32_t rt = dropout_row_term(b * s_q + i, op, drop.seed);
    float t = 0.0f;
    for (int j = 0; j < s_k; ++j) {
      const float p = ps[i][j] / z;
      const float kap = drop.on ? dropout_keep(rt, j, drop) : 1.0f;
      const float dp = drop.on ? dss[i][j] * kap : dss[i][j];
      ps[i][j] = p;
      dss[i][j] = dp;
      t += dp * p;
    }
    for (int j = 0; j < s_k; ++j) {
      const float p = ps[i][j];
      const float kap = drop.on ? dropout_keep(rt, j, drop) : 1.0f;
      dss[i][j] = bf16_round(p * (dss[i][j] - t) * scale);
      ps[i][j] = bf16_round(drop.on ? p * kap : p);
    }
  }
  __syncthreads();

  // dq = ds k
  for (int e = tid; e < s_q * hd; e += ATT_THREADS) {
    const int i = e / hd, d = e % hd;
    float acc = 0.0f;
    for (int j = 0; j < s_k; ++j) acc += dss[i][j] * __bfloat162float(ks[j * hd + d]);
    dq[(size_t)(b * s_q + i) * dq_ld + h * hd + d] = __float2bfloat16(acc);
  }
  // dk = ds^T q, dv = pd^T g
  for (int e = tid; e < s_k * hd; e += ATT_THREADS) {
    const int j = e / hd, d = e % hd;
    float ak = 0.0f, av = 0.0f;
    for (int i = 0; i < s_q; ++i) {
      ak += dss[i][j] * __bfloat162float(qs[i * hd + d]);
      av += ps[i][j] * __bfloat162float(gs[i * hd + d]);
    }
    const size_t o = (size_t)(b * s_k + j) * dkv_ld + h * hd + d;
    dk[o] = __float2bfloat16(ak);
    dv[o] = __float2bfloat16(av);
  }
}

inline bool attention_fits(int s_q, int s_k, int head_dim) {
  return s_q <= ATT_MAX_S && s_k <= ATT_MAX_S && head_dim <= ATT_MAX_HD;
}

template <bool WHERE_MASK = false>
void attention(const void* q, int q_ld, const void* k, const void* v, int kv_ld, const int* mask,
               void* ctx, int ctx_ld, int batch, int nh, int hd, int s_q, int s_k, int causal,
               DropoutParams drop, int op_base, cudaStream_t st) {
  attention_kernel<WHERE_MASK><<<batch * nh, ATT_THREADS, 0, st>>>(
      static_cast<const bf16*>(q), q_ld, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      kv_ld, mask, static_cast<bf16*>(ctx), ctx_ld, nh, hd, s_q, s_k, causal,
      1.0f / sqrtf(static_cast<float>(hd)), drop, op_base);
}

template <int UNUSED = 0>
void attention_bwd(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                   const int* mask, const void* g, void* dq, int dq_ld, void* dk, void* dv,
                   int dkv_ld, int batch, int nh, int hd, int s_q, int s_k, int causal,
                   DropoutParams drop, int op_base, cudaStream_t st) {
  attention_bwd_kernel<UNUSED><<<batch * nh, ATT_THREADS, 0, st>>>(
      static_cast<const bf16*>(q), q_ld, static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      kv_ld, mask, static_cast<const bf16*>(g), static_cast<bf16*>(dq), dq_ld,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), dkv_ld, nh, hd, s_q, s_k, causal,
      1.0f / sqrtf(static_cast<float>(hd)), drop, op_base);
}

}  // namespace
