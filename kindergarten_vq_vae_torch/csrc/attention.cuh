// Per-(sentence, head) attention for Hopper (sm_90a), forward and backward:
// the one implementation behind the layer kernels (layer_fwd.cu: #1 forward;
// layer_bwd.cu: #3 / #4 inside #2) and the standalone attention kernels
// (sdpa.cu: #11, #12, #13). It replaces the attention of these TPU kernels
// (kindergarten_vq_vae_tpu/ops/):
//   layer_pallas.py:244 `_attn_fwd_tile`, inside `_layer_fwd_kernel` (l.489), #1
//   layer_pallas.py:696 `_attn_bwd_self_kernel` (#3), l.712
//     `_attn_bwd_cross_kernel` (#4)
//   sdpa_pallas.py:103 `_sdpa_fwd_kernel` (#11), l.142 `_sdpa_bwd_kernel` (#12)
//   attention_pallas.py:65 `_mha_kernel` (#13)
//
// This file's kernels take up to 32 queries and keys and head_dim 128; the
// entry points below hand the rest to attention_long.cu (attention_long.cuh),
// which takes a head wider than 128 columns by length: up to 32 queries and
// keys a warp a (sentence, head) as here, over 64-column chunks
// (attention_wide_short_kernel), past that 64-row tiles (up to 512 tokens).
//
// The TPU kernels packed a tile of sentences into (rows, H) and computed
// dense block-diagonal (rows x rows) scores per head, because the 128x128 MXU
// wants large products; off-block scores were -1e9 and exp() sent them to
// exactly 0. Here each (sentence, head) is computed directly, which gives the
// same values without the off-block work.
//
// What bounds it on the H100: the bytes. A 12 x 12 x 64 head does ~20 KFLOP
// on ~4.6 KB in the forward (~10.7 KB in and out in the backward), far below
// the 295 FLOP a byte where the tensor cores would be the limit. So the
// design keeps the bytes in flight and the per-head chain short:
// - one warp computes one (sentence, head); a CTA's warps take consecutive
//   heads of a sentence, and the grid is persistent (SMs x resident CTAs,
//   from the occupancy of the shared memory each warp needs), each warp
//   walking over units (sentence, head) with a grid stride;
// - q, k, v (and g in the backward) are staged with 16-byte cp.async into
//   one buffer per warp, and the many resident warps hide each other's
//   loads. (A second buffer per warp, loading the next unit behind this
//   one's math, halves the resident warps and measured 15-25% slower on an
//   H100.)
//   Tiles are padded to 16 or 32 rows and to a head_dim multiple of 16, with
//   a row stride of that + 8 bf16 so that ldmatrix is free of bank conflicts;
//   the padding is zeroed once and never written again. Shared memory is
//   sized to the call's s and head_dim (dynamic), not to 32 x 128;
// - every product is mma.sync m16n8k16 (bf16 in, f32 accumulate) on
//   ldmatrix fragments (.trans for the transposed operands): S = Q K^T, then
//   P V with P's accumulator reused as the A fragment in registers; in the
//   backward also dP = G V^T, dQ = dS K (dS from registers), and dK = dS^T Q
//   and dV = (P kappa)^T G through shared copies of dS and P kappa;
// - the softmax, the key / causal masks and the dropout keep mask run in the
//   accumulator registers, with quad shuffles for the row max and sums;
// - outputs are staged in shared memory and written with 16-byte stores.
// Where a base pointer, a row stride or head_dim is not a multiple of 16
// bytes, the same kernel is instantiated with element loads and stores
// (chosen on the host).
//
// Rounding points (those of the TPU kernels): f32 scores, p = e / z in f32
// (e * (1 / z) for #13), expf, the hash-dropout keep mask (dropout_hash.cuh)
// applied to p after the softmax, p rounded to bf16 before p @ v, f32 sums,
// bf16 outputs. The backward recomputes p from q and k, rounds ds to bf16
// before dq / dk, and takes dv from bf16(p * kappa). Key columns past s_k
// are left out of the max and the sum (a fully masked sentence is uniform
// over its s_k keys); a masked or causal score has NEG_INF added (#13:
// replaced).
#pragma once

#include <atomic>
#include <cstdint>

#include "attention_long.cuh"
#include "dropout_hash.cuh"
#include "layer_common.cuh"

// Internal linkage in the including file's own anonymous namespace (an
// anonymous namespace nested in kvq is ambiguous in nvcc's host stubs).
namespace {

using namespace kvq;

// this file's kernels: up to 32 queries and keys and head_dim 128. Past
// ATT_MAX_HD the entries dispatch to attention_long.cu's wide kernels, which
// take any head_dim (ATT_MAX_S still picks their design); past ATT_MAX_S to
// its 64-row tiles.
constexpr int ATT_MAX_S = 32, ATT_MAX_HD = 128;
constexpr int ATT_WARPS = 4;                 // the most warps of a CTA
constexpr int ATT_SMEM_MAX = 227 * 1024;     // the most dynamic shared memory of a CTA

using AttArgs = AttnArgs<bf16>;  // attention_long.cuh

// One warp's shared memory, in bf16 elements: q, k, v (and g), then in the
// backward the copies of P kappa and dS ((sqp, skp) at row stride tld) and
// an output staging tile; last, the sentence's key mask.
struct AttPlan {
  int sqp, skp, hdp, ld;  // rows padded to 16 or 32, head_dim to 16s, ld = hdp + 8
  int tq, tk;             // elements of a q (or g) tile and of a k (or v) tile
  int buf;                // elements of the q, k, v (and g) tiles
  int tld;                // row stride of the P kappa / dS copies: skp + 8
  int bytes;              // a warp's bytes (a multiple of 16)
};

__host__ __device__ inline AttPlan att_plan(int s_q, int s_k, int hd, bool bwd) {
  AttPlan p;
  p.sqp = s_q > 16 ? 32 : 16;  // MT / KT m16 blocks (attention_short: s <= 32)
  p.skp = s_k > 16 ? 32 : 16;
  p.hdp = (hd + 15) & ~15;
  p.ld = p.hdp + 8;
  p.tq = p.sqp * p.ld;
  p.tk = p.skp * p.ld;
  p.buf = bwd ? 2 * (p.tq + p.tk) : p.tq + 2 * p.tk;
  p.tld = p.skp + 8;
  const int stage = (p.sqp > p.skp ? p.sqp : p.skp) * p.ld;
  const int extra = bwd ? 2 * p.sqp * p.tld + stage : 0;
  p.bytes = (p.buf + extra) * 2 + ATT_MAX_S * 4;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (f32 tiles too: an 8 x 8 b16 matrix is 8 rows of 4 f32, lane l taking row
// l / 4, word l % 4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row) b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows x hd of src (row stride src_ld) into smem at row stride ld: 16-byte
// cp.async (VEC: hd, src_ld and src 16-byte aligned) or element copies
template <bool VEC>
__device__ __forceinline__ void att_load(bf16* dst, int ld, const bf16* src, int src_ld, int rows,
                                         int hd, int lane) {
  if constexpr (VEC) {
    const int cpr = hd >> 3;
    for (int c = lane; c < rows * cpr; c += 32) {
      const int r = c / cpr, col = (c - r * cpr) << 3;
      cp_async16(dst + r * ld + col, src + (size_t)r * src_ld + col, true);
    }
  } else {
    for (int e = lane; e < rows * hd; e += 32) {
      const int r = e / hd, col = e - r * hd;
      dst[r * ld + col] = src[(size_t)r * src_ld + col];
    }
  }
}

// rows x hd of the staging tile (row stride ld) out to dst (row stride dst_ld)
template <bool VEC>
__device__ __forceinline__ void att_store(bf16* dst, int dst_ld, const bf16* src, int ld, int rows,
                                          int hd, int lane) {
  if constexpr (VEC) {
    const int cpr = hd >> 3;
    for (int c = lane; c < rows * cpr; c += 32) {
      const int r = c / cpr, col = (c - r * cpr) << 3;
      *reinterpret_cast<uint4*>(dst + (size_t)r * dst_ld + col) =
          *reinterpret_cast<const uint4*>(src + r * ld + col);
    }
  } else {
    for (int e = lane; e < rows * hd; e += 32) {
      const int r = e / hd, col = e - r * hd;
      dst[(size_t)r * dst_ld + col] = src[r * ld + col];
    }
  }
}

// one accumulator pair (row i, columns d, d + 1) into the staging tile as bf16
__device__ __forceinline__ void att_put(bf16* st, int ld, int i, int d, float v0, float v1,
                                        int rows, int hd) {
  if (i >= rows) return;
  if (d + 1 < hd)
    *reinterpret_cast<uint32_t*>(st + i * ld + d) = pack_bf16(v0, v1);
  else if (d < hd)
    st[i * ld + d] = __float2bfloat16(v0);
}

// Start the loads of unit u (sentence u / nh, head u % nh) into the warp's tiles.
template <bool VEC, bool BWD>
__device__ __forceinline__ void att_fetch(const AttArgs& a, const AttPlan& P, bf16* buf, int* msk,
                                          int u, int lane) {
  const int b = u / a.nh, h = u - b * a.nh;
  const size_t col = (size_t)h * a.hd;
  bf16* qs = buf;
  bf16* ks = qs + P.tq;
  bf16* vs = ks + P.tk;
  att_load<VEC>(qs, P.ld, a.q + (size_t)b * a.s_q * a.q_ld + col, a.q_ld, a.s_q, a.hd, lane);
  att_load<VEC>(ks, P.ld, a.k + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, a.s_k, a.hd, lane);
  att_load<VEC>(vs, P.ld, a.v + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, a.s_k, a.hd, lane);
  if constexpr (BWD) {
    const int H = a.nh * a.hd;
    att_load<VEC>(vs + P.tk, P.ld, a.g + (size_t)b * a.s_q * H + col, H, a.s_q, a.hd, lane);
  }
  if (a.key_mask != nullptr && lane < a.s_k) cp_async4(msk + lane, a.key_mask + b * a.s_k + lane);
}

// acc[mt][nt] += A[16 mt.., :] B[8 nt.., :]^T over the padded head dim, A and
// B row-major in smem at row stride ld (the q / g tile and the k / v tile);
// MT m16 row blocks of A, KT 16-row blocks of B
template <int MT, int KT>
__device__ __forceinline__ void att_abt(float (&acc)[MT][2 * KT][4], const bf16* A,
                                        const bf16* B, const AttPlan& P, int lane) {
  for (int d0 = 0; d0 < P.hdp; d0 += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(af[mt], A + (mt * 16 + (lane & 15)) * P.ld + d0 + (lane >> 4) * 8);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t bfr[4];  // n8 tiles 2 kt and 2 kt + 1, k 0..7 and 8..15
      ldsm_x4(bfr, B + (kt * 16 + (lane & 7) + ((lane >> 4) << 3)) * P.ld + d0 +
                       (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * kt], af[mt], bfr[0], bfr[1]);
        mma_bf16(acc[mt][2 * kt + 1], af[mt], bfr[2], bfr[3]);
      }
    }
  }
}

// B fragments of two n8 tiles (columns d0.., d0 + 8..) at k rows k0..k0 + 15
// of a row-major (k, n) tile: ldmatrix.trans
__device__ __forceinline__ void att_b_trans(uint32_t (&r)[4], const bf16* T, int ld, int k0,
                                            int d0, int lane) {
  ldsm_x4_t(r, T + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + d0 + ((lane >> 4) << 3));
}

// A fragment (16 x 16 at m0, k0) of the transpose of a row-major (k, m) tile
__device__ __forceinline__ void att_a_trans(uint32_t (&r)[4], const bf16* T, int ld, int k0,
                                            int m0, int lane) {
  ldsm_x4_t(r, T + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 + (((lane >> 3) & 1) << 3));
}

// accumulator tiles (2 kt, 2 kt + 1) of one m16 row block as an A fragment
template <int NT>
__device__ __forceinline__ void att_c_to_a(uint32_t (&a)[4], const float (&c)[NT][4], int kt) {
  a[0] = pack_bf16(c[2 * kt][0], c[2 * kt][1]);
  a[1] = pack_bf16(c[2 * kt][2], c[2 * kt][3]);
  a[2] = pack_bf16(c[2 * kt + 1][0], c[2 * kt + 1][1]);
  a[3] = pack_bf16(c[2 * kt + 1][2], c[2 * kt + 1][3]);
}

// The scores of row i (this thread's columns j = 8 nt + 2 (lane % 4) + c),
// masked and scaled, in place; returns the row max over the real keys.
// Args: AttArgs, or the f32 kernel's AttF32Args.
template <bool WHERE_MASK, int NT, typename Args>
__device__ __forceinline__ float att_scores(float (&s)[NT][4], int r, int i, const Args& a,
                                            const int* msk, int lane) {
  float mx = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = nt * 8 + 2 * (lane & 3) + c;
      float x = -INFINITY;
      if (j < a.s_k) {
        bool ok = a.key_mask == nullptr || msk[j] > 0;
        if (a.causal && j > i) ok = false;
        const float acc = s[nt][2 * r + c];
        if constexpr (WHERE_MASK)
          x = ok ? acc * a.scale : NEG_INF;
        else
          x = acc * a.scale + (ok ? 0.0f : NEG_INF);
        mx = fmaxf(mx, x);
      }
      s[nt][2 * r + c] = x;
    }
  return quad_max(mx);
}

// e = exp(x - max) over the real keys, 0 past s_k, in place; returns the row sum
template <int NT>
__device__ __forceinline__ float att_exp(float (&s)[NT][4], int r, float mx, int s_k, int lane) {
  float z = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = nt * 8 + 2 * (lane & 3) + c;
      const float e = j < s_k ? expf(s[nt][2 * r + c] - mx) : 0.0f;
      s[nt][2 * r + c] = e;
      z += e;
    }
  return quad_sum(z);
}

// Forward of one unit from its buffer: ctx rows of the sentence, head h.
template <bool WHERE_MASK, bool VEC, int MT, int KT>
__device__ __forceinline__ void attention_unit(const AttArgs& a, const AttPlan& P, bf16* buf,
                                               const int* msk, int u, int lane) {
  const int b = u / a.nh, h = u - b * a.nh;
  bf16* qs = buf;
  const bf16* ks = qs + P.tq;
  const bf16* vs = ks + P.tk;
  const int g8 = lane >> 2, t4 = lane & 3;

  float s[MT][2 * KT][4] = {};
  att_abt<MT, KT>(s, qs, ks, P, lane);

  // softmax as e / z in f32 (#13: e * (1 / z)), times the keep mask
  uint32_t pa[MT][KT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = mt * 16 + g8 + 8 * r;
      const float mx = att_scores<WHERE_MASK>(s[mt], r, i, a, msk, lane);
      const float z = att_exp(s[mt], r, mx, a.s_k, lane);
      const float inv_z = 1.0f / z;
      const uint32_t rt = dropout_row_term(b * a.s_q + i, a.op_base + h, a.drop.seed);
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = nt * 8 + 2 * t4 + c;
          float p = 0.0f;
          if (j < a.s_k) {
            if constexpr (WHERE_MASK) {
              p = s[mt][nt][2 * r + c] * inv_z;
            } else {
              p = s[mt][nt][2 * r + c] / z;
              if (a.drop.on) p *= dropout_keep(rt, j, a.drop);
            }
          }
          s[mt][nt][2 * r + c] = p;
        }
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) att_c_to_a(pa[mt][kt], s[mt], kt);
  }

  // ctx = bf16(p) v, 16 columns at a time, staged in the spent q tile
  __syncwarp();
  for (int d0 = 0; d0 < P.hdp; d0 += 16) {
    float o[MT][2][4] = {};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t bv[4];
      att_b_trans(bv, vs, P.ld, kt * 16, d0, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][0], pa[mt][kt], bv[0], bv[1]);
        mma_bf16(o[mt][1], pa[mt][kt], bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          att_put(qs, P.ld, mt * 16 + g8 + 8 * r, d0 + n * 8 + 2 * t4, o[mt][n][2 * r],
                  o[mt][n][2 * r + 1], a.s_q, a.hd);
  }
  __syncwarp();
  att_store<VEC>(a.out + (size_t)b * a.s_q * a.out_ld + (size_t)h * a.hd, a.out_ld, qs, P.ld,
                 a.s_q, a.hd, lane);
}

// Backward of one unit, recomputing the probabilities from q and k:
//   p = softmax(q k^T * scale + bias), kappa = keep mask (op_base + h)
//   dv = bf16(p * kappa)^T g;  dp = (g v^T) * kappa;  t = rowsum(dp * p)
//   ds = bf16(p * (dp - t) * scale);  dq = ds k;  dk = ds^T q
// with g the context gradient, every product accumulated in f32 and dq, dk,
// dv written in bf16 (as `_attn_bwd_call` and `_sdpa_bwd_kernel` return them).
template <bool VEC, int MT, int KT>
__device__ __forceinline__ void attention_bwd_unit(const AttArgs& a, const AttPlan& P, bf16* buf,
                                                   const int* msk, bf16* pk, bf16* dst,
                                                   bf16* stage, int u, int lane) {
  const int b = u / a.nh, h = u - b * a.nh;
  const bf16* qs = buf;
  const bf16* ks = qs + P.tq;
  const bf16* vs = ks + P.tk;
  const bf16* gs = vs + P.tk;
  const int g8 = lane >> 2, t4 = lane & 3;

  float s[MT][2 * KT][4] = {}, dp[MT][2 * KT][4] = {};
  att_abt<MT, KT>(s, qs, ks, P, lane);
  att_abt<MT, KT>(dp, gs, vs, P, lane);

  // per query row: p, dp * kappa, bf16(p * kappa) into pk, t, then ds
  uint32_t dsa[MT][KT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = mt * 16 + g8 + 8 * r;
      const bool row = i < a.s_q;
      const float mx = att_scores<false>(s[mt], r, i, a, msk, lane);
      const float z = att_exp(s[mt], r, mx, a.s_k, lane);
      const uint32_t rt = dropout_row_term(b * a.s_q + i, a.op_base + h, a.drop.seed);
      float t = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        float pd[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int j = nt * 8 + 2 * t4 + c;
          float p = 0.0f, d = 0.0f, kap = 1.0f;
          if (row && j < a.s_k) {
            p = s[mt][nt][2 * r + c] / z;
            d = dp[mt][nt][2 * r + c];
            if (a.drop.on) {
              kap = dropout_keep(rt, j, a.drop);
              d *= kap;
            }
            t += d * p;
          }
          s[mt][nt][2 * r + c] = p;
          dp[mt][nt][2 * r + c] = d;
          pd[c] = a.drop.on ? p * kap : p;
        }
        *reinterpret_cast<uint32_t*>(pk + i * P.tld + nt * 8 + 2 * t4) = pack_bf16(pd[0], pd[1]);
      }
      t = quad_sum(t);
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          ds[c] = bf16_round(s[mt][nt][2 * r + c] * (dp[mt][nt][2 * r + c] - t) * a.scale);
          dp[mt][nt][2 * r + c] = ds[c];
        }
        *reinterpret_cast<uint32_t*>(dst + i * P.tld + nt * 8 + 2 * t4) = pack_bf16(ds[0], ds[1]);
      }
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) att_c_to_a(dsa[mt][kt], dp[mt], kt);
  }
  __syncwarp();

  // dq = ds k (ds from registers)
  for (int d0 = 0; d0 < P.hdp; d0 += 16) {
    float o[MT][2][4] = {};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t bk[4];
      att_b_trans(bk, ks, P.ld, kt * 16, d0, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][0], dsa[mt][kt], bk[0], bk[1]);
        mma_bf16(o[mt][1], dsa[mt][kt], bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          att_put(stage, P.ld, mt * 16 + g8 + 8 * r, d0 + n * 8 + 2 * t4, o[mt][n][2 * r],
                  o[mt][n][2 * r + 1], a.s_q, a.hd);
  }
  __syncwarp();
  att_store<VEC>(a.out + (size_t)b * a.s_q * a.out_ld + (size_t)h * a.hd, a.out_ld, stage, P.ld,
                 a.s_q, a.hd, lane);
  __syncwarp();

  // dk = ds^T q and dv = (p kappa)^T g: rows are keys, the sum runs over queries
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const bf16* T = which == 0 ? dst : pk;
    const bf16* X = which == 0 ? qs : gs;
    bf16* out = which == 0 ? a.dk : a.dv;
    uint32_t at[KT][MT][4];  // [key block][query block]
#pragma unroll
    for (int mk = 0; mk < KT; ++mk)
#pragma unroll
      for (int kq = 0; kq < MT; ++kq) att_a_trans(at[mk][kq], T, P.tld, kq * 16, mk * 16, lane);
    for (int d0 = 0; d0 < P.hdp; d0 += 16) {
      float o[KT][2][4] = {};
#pragma unroll
      for (int kq = 0; kq < MT; ++kq) {
        uint32_t bx[4];
        att_b_trans(bx, X, P.ld, kq * 16, d0, lane);
#pragma unroll
        for (int mk = 0; mk < KT; ++mk) {
          mma_bf16(o[mk][0], at[mk][kq], bx[0], bx[1]);
          mma_bf16(o[mk][1], at[mk][kq], bx[2], bx[3]);
        }
      }
#pragma unroll
      for (int mk = 0; mk < KT; ++mk)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            att_put(stage, P.ld, mk * 16 + g8 + 8 * r, d0 + n * 8 + 2 * t4, o[mk][n][2 * r],
                    o[mk][n][2 * r + 1], a.s_k, a.hd);
    }
    __syncwarp();
    att_store<VEC>(out + (size_t)b * a.s_k * a.dkv_ld + (size_t)h * a.hd, a.dkv_ld, stage, P.ld,
                   a.s_k, a.hd, lane);
    __syncwarp();
  }
}

__device__ __forceinline__ void att_zero(void* base, int bytes, int lane) {
  uint4* p = static_cast<uint4*>(base);
  for (int i = lane; i < bytes / 16; i += 32) p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// The persistent loop of one warp over its units.
template <bool BWD, bool WHERE_MASK, bool VEC, int MT, int KT>
__device__ __forceinline__ void att_walk(const AttArgs& a, unsigned char* att_smem) {
  const AttPlan P = att_plan(a.s_q, a.s_k, a.hd, BWD);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  bf16* base = reinterpret_cast<bf16*>(att_smem + (size_t)warp * P.bytes);
  int* msk = reinterpret_cast<int*>(att_smem + (size_t)(warp + 1) * P.bytes) - ATT_MAX_S;
  bf16* pk = base + P.buf;  // backward only
  bf16* dst = pk + P.sqp * P.tld;
  bf16* stage = dst + P.sqp * P.tld;
  att_zero(base, P.bytes, lane);
  __syncwarp();

  const int total = a.batch * a.nh, stride = gridDim.x * nw;
  for (int u = blockIdx.x * nw + warp; u < total; u += stride) {
    att_fetch<VEC, BWD>(a, P, base, msk, u, lane);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    if constexpr (BWD)
      attention_bwd_unit<VEC, MT, KT>(a, P, base, msk, pk, dst, stage, u, lane);
    else
      attention_unit<WHERE_MASK, VEC, MT, KT>(a, P, base, msk, u, lane);
    __syncwarp();  // every lane is done with the tiles before the next unit's loads
  }
}

// WHERE_MASK (#13, attention_pallas.py `_mha_kernel` l.65): a masked or
// causal score is replaced by NEG_INF instead of having NEG_INF added to it
// (l.95-101), p = e * (1 / z) (l.113-118), and there is no dropout. A fully
// masked row is then uniform over all keys. MT / KT: the m16 blocks of
// queries / keys (1 for up to 16 rows, 2 for up to 32).
template <bool WHERE_MASK, bool VEC, int MT, int KT>
__global__ void __launch_bounds__(32 * ATT_WARPS) attention_kernel(AttArgs a) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  att_walk<false, WHERE_MASK, VEC, MT, KT>(a, att_smem);
}

template <bool VEC, int MT, int KT>
__global__ void __launch_bounds__(32 * ATT_WARPS) attention_bwd_kernel(AttArgs a) {
  extern __shared__ __align__(16) unsigned char att_smem[];
  att_walk<true, false, VEC, MT, KT>(a, att_smem);
}

// whether this file's kernels take the call (attention_long.cuh's
// attention_fits says what the entry points take)
inline bool attention_short(int s_q, int s_k) { return s_q <= ATT_MAX_S && s_k <= ATT_MAX_S; }

// 16-byte loads and stores: every base pointer, row stride and head offset a
// multiple of 16 bytes (8 bf16, 4 f32; Args: AttArgs or AttF32Args)
template <typename Args>
inline bool att_vec(const Args& a, bool bwd) {
  constexpr int E = 16 / static_cast<int>(sizeof(*a.q));
  auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  bool ok = a.hd % E == 0 && a.q_ld % E == 0 && a.kv_ld % E == 0 && a.out_ld % E == 0 &&
            al(a.q) && al(a.k) && al(a.v) && al(a.out);
  if (bwd) ok = ok && a.dkv_ld % E == 0 && al(a.g) && al(a.dk) && al(a.dv);
  return ok;
}

// Launch geometry of a kernel whose warps each take `bytes` of shared
// memory (the bf16 kernels here, the f32 ones of attention_f32.cuh and the
// wide-head ones of attention_long.cu; Args their arguments, `extra` any
// arguments after them): the warps of a CTA and the CTAs the card holds at
// once (the most resident warps an SM for this shared memory and these
// registers), cached per kernel, device and per-warp bytes; the grid is that
// many CTAs on every SM, or fewer when the units run out.
template <typename Args, auto KERNEL, typename... Extra>
int att_launch(const Args& a, int bytes, cudaStream_t st, Extra... extra) {
  const int total = a.batch * a.nh;
  if (total <= 0 || a.s_q <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int DEVS = 16;
  static std::atomic<unsigned long long> plan[DEVS];  // bytes << 32 | nw << 16 | per_sm
  static std::atomic<int> attrs_set[DEVS];
  const int slot = dev % DEVS;
  if (!attrs_set[slot].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, ATT_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributePreferredSharedMemoryCarveout,
                               static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return static_cast<int>(e);
    attrs_set[slot].store(1, std::memory_order_release);
  }
  unsigned long long c = plan[slot].load(std::memory_order_relaxed);
  if ((c >> 32) != static_cast<unsigned long long>(bytes)) {
    int best_nw = 1, best_per_sm = 0;
    for (int nw = ATT_WARPS; nw >= 1; --nw) {
      if (nw * bytes > ATT_SMEM_MAX) continue;
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, 32 * nw, nw * bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (per_sm * nw > best_per_sm * best_nw) best_nw = nw, best_per_sm = per_sm;
    }
    if (best_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    c = (static_cast<unsigned long long>(bytes) << 32) | (best_nw << 16) | best_per_sm;
    plan[slot].store(c, std::memory_order_relaxed);
  }
  const int nw = static_cast<int>((c >> 16) & 0xffff), per_sm = static_cast<int>(c & 0xffff);
  const int ctas = (total + nw - 1) / nw;
  const int grid = ctas < sms * per_sm ? ctas : sms * per_sm;
  KERNEL<<<grid, 32 * nw, nw * bytes, st>>>(a, extra...);
  return static_cast<int>(cudaGetLastError());
}

// ctx (batch*s_q rows at ctx_ld) = attention of q (rows at q_ld, head h at
// column h*hd) over k / v (rows at kv_ld); mask (batch, s_k) int32 or null;
// head h drops with op id op_base + h. Returns a CUDA error code.
template <bool WHERE_MASK = false>
int attention(const void* q, int q_ld, const void* k, const void* v, int kv_ld, const int* mask,
              void* ctx, int ctx_ld, int batch, int nh, int hd, int s_q, int s_k, int causal,
              DropoutParams drop, int op_base, cudaStream_t st) {
  const AttArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), mask, nullptr, static_cast<bf16*>(ctx), nullptr,
                  nullptr, q_ld, kv_ld, ctx_ld, 0, batch, nh, hd, s_q, s_k, causal, op_base,
                  1.0f / sqrtf(static_cast<float>(hd)), drop};
  if (!attention_short(s_q, s_k) || hd > ATT_MAX_HD)
    return attention_long_fwd(a, WHERE_MASK, st);
  const int blocks = (s_q > 16) * 2 + (s_k > 16);  // the m16 blocks of queries and of keys
  const int bytes = att_plan(s_q, s_k, hd, false).bytes;
  if (att_vec(a, false)) {
    switch (blocks) {
      case 0: return att_launch<AttArgs, attention_kernel<WHERE_MASK, true, 1, 1>>(a, bytes, st);
      case 1: return att_launch<AttArgs, attention_kernel<WHERE_MASK, true, 1, 2>>(a, bytes, st);
      case 2: return att_launch<AttArgs, attention_kernel<WHERE_MASK, true, 2, 1>>(a, bytes, st);
      default: return att_launch<AttArgs, attention_kernel<WHERE_MASK, true, 2, 2>>(a, bytes, st);
    }
  }
  switch (blocks) {
    case 0: return att_launch<AttArgs, attention_kernel<WHERE_MASK, false, 1, 1>>(a, bytes, st);
    case 1: return att_launch<AttArgs, attention_kernel<WHERE_MASK, false, 1, 2>>(a, bytes, st);
    case 2: return att_launch<AttArgs, attention_kernel<WHERE_MASK, false, 2, 1>>(a, bytes, st);
    default: return att_launch<AttArgs, attention_kernel<WHERE_MASK, false, 2, 2>>(a, bytes, st);
  }
}

// dq (rows at dq_ld), dk and dv (rows at dkv_ld) of attention()'s output,
// given its gradient g (batch*s_q contiguous rows of nh*hd); stats: the
// 64-row tiles' scratch (AttnArgs::stats; null up to 32 queries and keys, at
// any head_dim). A template, so that a file that does not launch it compiles
// none of it.
template <int UNUSED = 0>
int attention_bwd(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                  const int* mask, const void* g, void* dq, int dq_ld, void* dk, void* dv,
                  int dkv_ld, int batch, int nh, int hd, int s_q, int s_k, int causal,
                  DropoutParams drop, int op_base, float* stats, cudaStream_t st) {
  const AttArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), mask, static_cast<const bf16*>(g),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), q_ld,
                  kv_ld, dq_ld, dkv_ld, batch, nh, hd, s_q, s_k, causal, op_base,
                  1.0f / sqrtf(static_cast<float>(hd)), drop, stats};
  if (!attention_short(s_q, s_k) || hd > ATT_MAX_HD) return attention_long_bwd(a, st);
  const int blocks = (s_q > 16) * 2 + (s_k > 16);
  const int bytes = att_plan(s_q, s_k, hd, true).bytes;
  if (att_vec(a, true)) {
    switch (blocks) {
      case 0: return att_launch<AttArgs, attention_bwd_kernel<true, 1, 1>>(a, bytes, st);
      case 1: return att_launch<AttArgs, attention_bwd_kernel<true, 1, 2>>(a, bytes, st);
      case 2: return att_launch<AttArgs, attention_bwd_kernel<true, 2, 1>>(a, bytes, st);
      default: return att_launch<AttArgs, attention_bwd_kernel<true, 2, 2>>(a, bytes, st);
    }
  }
  switch (blocks) {
    case 0: return att_launch<AttArgs, attention_bwd_kernel<false, 1, 1>>(a, bytes, st);
    case 1: return att_launch<AttArgs, attention_bwd_kernel<false, 1, 2>>(a, bytes, st);
    case 2: return att_launch<AttArgs, attention_bwd_kernel<false, 2, 1>>(a, bytes, st);
    default: return att_launch<AttArgs, attention_bwd_kernel<false, 2, 2>>(a, bytes, st);
  }
}

}  // namespace
