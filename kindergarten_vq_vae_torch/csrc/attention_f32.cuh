// Per-(sentence, head) attention in f32 for Hopper (sm_90a), forward and
// backward: the f32 instance of attention.cuh, behind the f32 layer forward
// (layer_fwd.cu, #1), the f32 attention backward (layer_bwd.cu, #3 / #4
// inside #2) and sdpa.cu's f32 entries. It replaces, in f32 (JAX's parity
// dtype, in which its Pallas kernels run), the attention of
// kindergarten_vq_vae_tpu/ops/:
//   layer_pallas.py:244 `_attn_fwd_tile`, inside `_layer_fwd_kernel` (l.489), #1
//   layer_pallas.py:696 `_attn_bwd_self_kernel` (#3), l.712
//     `_attn_bwd_cross_kernel` (#4)
//   sdpa_pallas.py:103 `_sdpa_fwd_kernel` (#11), l.142 `_sdpa_bwd_kernel` (#12)
//   attention_pallas.py:65 `_mha_kernel` (#13): WHERE_MASK, where a masked or
//     causal score is replaced by NEG_INF (l.95-101) and p = e * (1 / z)
//     (l.113-118), with no dropout (a fully masked row is uniform over its
//     s_k keys)
//
// attention.cuh's products are mma.sync m16n8k16 on bf16 fragments, which
// have no f32 form. The scores are at most 32 x 32 and head_dim at most 128:
// at the step's 12 x 12 x 64 a head does ~37 KFLOP in the forward on ~9 KB,
// well below the f32 units' ~20 FLOP a byte, so plain FFMA (exact f32
// arithmetic) costs nothing the bytes do not. The design:
// - one warp a (sentence, head), 4 warps a CTA, one unit a warp;
// - q, k, v (and g in the backward) staged in shared memory as f32 rows of
//   an odd stride (head_dim, or head_dim + 1), so that lane j walking key
//   row j and lane d walking column d are both free of bank conflicts;
// - a query row at a time: lane j computes score j (q_i . k_j * scale plus
//   the finite NEG_INF of a masked key or of j > i under the causal mask),
//   the row's max and sum by shuffles, p = e / z in f32 with expf, times the
//   keep mask of dropout_hash.cuh (query row b * s_q + i, key j, op id
//   op_base + h: attention.cuh's ids, so the keep masks are the same bits);
//   p goes to shared memory, and lane d sums p v over the keys;
// - the backward recomputes p, takes dp = g v^T times the keep mask, t =
//   rowsum(dp * p), ds = p (dp - t) * scale, then dq = ds k, dk = ds^T q and
//   dv = (p kappa)^T g, lane d each.
// There are no rounding points between the products: in f32 the TPU
// kernels' casts to the compute dtype are identities. Key columns past s_k
// are left out of the max and the sum (a fully masked sentence is uniform
// over its s_k keys).
#pragma once

#include <cmath>
#include <cstdint>

#include "dropout_hash.cuh"
#include "layer_common.cuh"

// Internal linkage in the including file's own anonymous namespace, as
// attention.cuh.
namespace {

using namespace kvq;

constexpr int ATTF_MAX_S = 32, ATTF_MAX_HD = 128;
constexpr int ATTF_WARPS = 4;              // the most warps of a CTA
constexpr int ATTF_SMEM_MAX = 227 * 1024;  // the most dynamic shared memory of a CTA
constexpr int ATTF_PLD = ATTF_MAX_S + 1;   // row stride of the p / ds tiles
constexpr float ATTF_NEG_INF = -1e9f;      // finite, as sdpa_pallas.py NEG_INF

struct AttF32Args {
  const float* q;
  const float* k;
  const float* v;
  const int* key_mask;  // (batch, s_k) int32 or null (all keys valid)
  const float* g;       // backward: the context gradient, rows of nh * hd
  float* out;           // forward: ctx; backward: dq
  float* dk;
  float* dv;
  int q_ld, kv_ld, out_ld, dkv_ld;
  int batch, nh, hd, s_q, s_k, causal, op_base;
  float scale;
  DropoutParams drop;
};

// the row stride of a staged q / k / v / g tile: odd
__host__ __device__ inline int attf_ld(int hd) { return hd | 1; }

// a warp's floats: q (s_q rows), k, v (s_k rows), g in the backward, then the
// p tile (and ds in the backward), then the key mask
__host__ __device__ inline int attf_floats(int s_q, int s_k, int hd, bool bwd) {
  return (s_q * (bwd ? 2 : 1) + 2 * s_k) * attf_ld(hd) + (bwd ? 2 : 1) * s_q * ATTF_PLD +
         ATTF_MAX_S;
}

__device__ __forceinline__ float attf_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows x hd of src (row stride src_ld) into a staged tile
__device__ __forceinline__ void attf_load(float* dst, const float* src, int src_ld, int rows,
                                          int hd, int lane) {
  const int ld = attf_ld(hd);
  for (int e = lane; e < rows * hd; e += 32) {
    const int r = e / hd, c = e - r * hd;
    dst[r * ld + c] = __ldg(src + (size_t)r * src_ld + c);
  }
}

// p_ij for lane j = key j of query row i (0 past s_k), before dropout;
// also its keep factor (1 without dropout). WHERE_MASK: #13's masking and
// p = e * (1 / z).
template <bool WHERE_MASK>
__device__ __forceinline__ float attf_prob(const AttF32Args& a, const float* qs, const float* ks,
                                           const int* msk, int b, int h, int i, int lane,
                                           float& kap) {
  const int ld = attf_ld(a.hd), j = lane;
  const bool key = j < a.s_k;
  float x = -INFINITY;
  if (key) {
    float acc = 0.0f;
    for (int d = 0; d < a.hd; ++d) acc = fmaf(qs[i * ld + d], ks[j * ld + d], acc);
    const bool ok = msk[j] > 0 && !(a.causal && j > i);
    if constexpr (WHERE_MASK)
      x = ok ? acc * a.scale : ATTF_NEG_INF;
    else
      x = acc * a.scale + (ok ? 0.0f : ATTF_NEG_INF);
  }
  const float mx = attf_warp_max(x);
  const float e = key ? expf(x - mx) : 0.0f;
  const float z = warp_sum(e);
  kap = 1.0f;
  if constexpr (WHERE_MASK) return key ? e * (1.0f / z) : 0.0f;
  if (key && a.drop.on)
    kap = dropout_keep(dropout_row_term(b * a.s_q + i, a.op_base + h, a.drop.seed), j, a.drop);
  return key ? e / z : 0.0f;
}

// out rows (row stride out_ld, column d) = T^T-or-T weighted sums of X rows:
// out[r][d] = sum over c < n of w[r, c] * X[c][d], w(r, c) = W[r * ATTF_PLD + c]
// (TRANS: W[c * ATTF_PLD + r])
template <bool TRANS>
__device__ __forceinline__ void attf_mix(float* out, int out_ld, int rows, const float* W,
                                         const float* X, int n, int hd, int lane) {
  const int ld = attf_ld(hd);
  for (int r = 0; r < rows; ++r)
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.0f;
      for (int c = 0; c < n; ++c)
        acc = fmaf(TRANS ? W[c * ATTF_PLD + r] : W[r * ATTF_PLD + c], X[c * ld + d], acc);
      out[(size_t)r * out_ld + d] = acc;
    }
}

template <bool BWD, bool WHERE_MASK>
__global__ void __launch_bounds__(32 * ATTF_WARPS) attention_f32_kernel(AttF32Args a) {
  extern __shared__ __align__(16) float attf_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * (blockDim.x >> 5) + warp;
  if (u >= a.batch * a.nh) return;
  const int b = u / a.nh, h = u - b * a.nh, ld = attf_ld(a.hd);
  float* qs = attf_smem + (size_t)warp * attf_floats(a.s_q, a.s_k, a.hd, BWD);
  float* ks = qs + a.s_q * ld;
  float* vs = ks + a.s_k * ld;
  float* gs = vs + a.s_k * ld;              // backward only
  float* ps = gs + (BWD ? a.s_q * ld : 0);  // p (p kappa in the backward)
  float* ds = ps + a.s_q * ATTF_PLD;        // backward only
  int* msk = reinterpret_cast<int*>(ds + (BWD ? a.s_q * ATTF_PLD : 0));
  const size_t col = (size_t)h * a.hd;

  attf_load(qs, a.q + (size_t)b * a.s_q * a.q_ld + col, a.q_ld, a.s_q, a.hd, lane);
  attf_load(ks, a.k + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, a.s_k, a.hd, lane);
  attf_load(vs, a.v + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, a.s_k, a.hd, lane);
  if constexpr (BWD) {
    const int H = a.nh * a.hd;
    attf_load(gs, a.g + (size_t)b * a.s_q * H + col, H, a.s_q, a.hd, lane);
  }
  if (lane < a.s_k) msk[lane] = a.key_mask == nullptr ? 1 : a.key_mask[b * a.s_k + lane];
  __syncwarp();

  const int j = lane;
  for (int i = 0; i < a.s_q; ++i) {
    float kap;
    const float p = attf_prob<WHERE_MASK>(a, qs, ks, msk, b, h, i, lane, kap);
    if constexpr (!BWD) {
      if (j < a.s_k) ps[i * ATTF_PLD + j] = p * kap;
    } else {
      float dp = 0.0f;
      if (j < a.s_k) {
        for (int d = 0; d < a.hd; ++d) dp = fmaf(gs[i * ld + d], vs[j * ld + d], dp);
        dp *= kap;
      }
      const float t = warp_sum(dp * p);
      if (j < a.s_k) {
        ps[i * ATTF_PLD + j] = p * kap;
        ds[i * ATTF_PLD + j] = p * (dp - t) * a.scale;
      }
    }
  }
  __syncwarp();

  if constexpr (!BWD) {  // ctx = (p kappa) v
    attf_mix<false>(a.out + (size_t)b * a.s_q * a.out_ld + col, a.out_ld, a.s_q, ps, vs, a.s_k,
                    a.hd, lane);
  } else {  // dq = ds k, dk = ds^T q, dv = (p kappa)^T g
    attf_mix<false>(a.out + (size_t)b * a.s_q * a.out_ld + col, a.out_ld, a.s_q, ds, ks, a.s_k,
                    a.hd, lane);
    attf_mix<true>(a.dk + (size_t)b * a.s_k * a.dkv_ld + col, a.dkv_ld, a.s_k, ds, qs, a.s_q,
                   a.hd, lane);
    attf_mix<true>(a.dv + (size_t)b * a.s_k * a.dkv_ld + col, a.dkv_ld, a.s_k, ps, gs, a.s_q,
                   a.hd, lane);
  }
}

inline bool attention_f32_fits(int s_q, int s_k, int head_dim) {
  return s_q >= 1 && s_k >= 1 && s_q <= ATTF_MAX_S && s_k <= ATTF_MAX_S && head_dim >= 1 &&
         head_dim <= ATTF_MAX_HD;
}

template <bool BWD, bool WHERE_MASK = false>
int attf_launch(const AttF32Args& a, cudaStream_t st) {
  const int total = a.batch * a.nh;
  if (total <= 0) return 0;
  if (!attention_f32_fits(a.s_q, a.s_k, a.hd)) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = attf_floats(a.s_q, a.s_k, a.hd, BWD) * 4;
  int nw = ATTF_SMEM_MAX / bytes;
  nw = nw < ATTF_WARPS ? nw : ATTF_WARPS;
  auto* kernel = attention_f32_kernel<BWD, WHERE_MASK>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nw * bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(total + nw - 1) / nw, 32 * nw, nw * bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ctx (batch*s_q rows at ctx_ld) = attention of q (rows at q_ld, head h at
// column h*hd) over k / v (rows at kv_ld), all f32; mask (batch, s_k) int32
// or null; head h drops with op id op_base + h (WHERE_MASK: #13, no
// dropout). Returns a CUDA error code.
template <bool WHERE_MASK = false>
inline int attention_f32(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                         const int* mask, void* ctx, int ctx_ld, int batch, int nh, int hd,
                         int s_q, int s_k, int causal, DropoutParams drop, int op_base,
                         cudaStream_t st) {
  const AttF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), mask, nullptr, static_cast<float*>(ctx),
                     nullptr, nullptr, q_ld, kv_ld, ctx_ld, 0, batch, nh, hd, s_q, s_k, causal,
                     op_base, 1.0f / sqrtf(static_cast<float>(hd)), drop};
  return attf_launch<false, WHERE_MASK>(a, st);
}

// dq (rows at dq_ld), dk and dv (rows at dkv_ld) of attention_f32()'s output
// given its gradient g (batch*s_q contiguous rows of nh*hd), all f32.
inline int attention_f32_bwd(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                             const int* mask, const void* g, void* dq, int dq_ld, void* dk,
                             void* dv, int dkv_ld, int batch, int nh, int hd, int s_q, int s_k,
                             int causal, DropoutParams drop, int op_base, cudaStream_t st) {
  const AttF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), mask, static_cast<const float*>(g),
                     static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                     q_ld, kv_ld, dq_ld, dkv_ld, batch, nh, hd, s_q, s_k, causal, op_base,
                     1.0f / sqrtf(static_cast<float>(hd)), drop};
  return attf_launch<true>(a, st);
}

}  // namespace
