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
// Up to 32 queries and keys and head_dim 128; attf_launch hands longer
// sentences (up to 512) and wider heads to attention_long.cu
// (attention_long.cuh): past head_dim 128 its short wide kernels up to 32
// tokens (a warp a (sentence, head) over 64-column chunks), its 64-row tiles
// beyond.
//
// What bounds it on the H100: the bytes. A 12 x 12 x 64 head moves ~9 KB in
// the forward (~21 KB in and out in the backward) for ~37 (~110) KFLOP; at
// batch 2048 x 12 heads that is a 0.090 (0.158) ms byte bound against
// 0.014 (0.041) ms of f32 FMA, yet FFMA with both operands read from shared
// memory, one lane a key, ran at 4-6x the bound on an H100 80GB HBM3 at 700
// W: so the products go to the tensor cores. This kernel takes ~0.12 /
// ~0.28 ms on that card (73% / 56% of the bound; PERF.md has the rows). What
// holds it there is the instructions each warp issues for a unit between its
// loads and its stores, with 11 (backward) to 16 (forward) warps resident an
// SM; hence the TF32 split on two integer operations (to_tf32_int: ptxas
// expands cvt.rna with a NaN test, and on it the backward took 23% longer on
// that card) and staging loops without a division. attention.cuh's design,
// in f32:
// - one warp a (sentence, head), over a persistent grid (SMs x resident
//   CTAs from the occupancy of each warp's shared memory, att_launch), each
//   warp walking over units with a grid stride;
// - q, k, v (and g) staged with 16-byte cp.async, every chunk of a unit
//   issued before the first wait, into tiles padded to 16 or 32 rows and to
//   a head_dim multiple of 8, at a row stride of that + 4 floats (16-byte
//   rows; fragment reads free of bank conflicts); the padding is zeroed once
//   and never written. One set of tiles a warp: a second set, loading the
//   next unit behind this one's math, halves the resident warps and
//   measured 25-35% slower on that card;
// - every product on the tensor cores in 3xTF32 (split_tf32<true>: the f32
//   GEMM's split, on to_tf32_int): mma.sync m16n8k8 tf32 on small * big,
//   big * small, then big * big, into one f32 accumulator (no K here is
//   longer than 128; the card tests hold each output to ~1e-6 of its largest
//   against f64); each operand element is split once for the fragment it
//   feeds. S = Q K^T and dP = G V^T read both operands with ldmatrix (8 x 4
//   f32 blocks).
//   ctx = (P kappa) V and dQ = dS K take P / dS from the accumulator
//   registers: the k8 step's slot t holds key 2t and slot t + 4 key 2t + 1,
//   the accumulator's own columns, and B's rows are read in the same order
//   (from the row-major tile, a pair of rows a lane, conflict-free). dK =
//   dS^T Q and dV = (P kappa)^T G read dS and P kappa from shared copies in
//   that order too;
// - the softmax, the key / causal masks and the dropout keep mask run in the
//   accumulator registers, with quad shuffles for the row max and sums
//   (attention.cuh's att_scores / att_exp);
// - outputs are staged in shared memory (the spent q tile in the forward,
//   the spent v tile in the backward) and written with 16-byte stores.
// Where a base pointer, a row stride or head_dim is not a multiple of 16
// bytes, the same kernel is instantiated with element loads and stores
// (chosen on the host).
//
// Rounding points: f32 scores q k^T * scale plus the finite NEG_INF of a
// masked key or of j > i under the causal mask (#13: replaced by it), p = e /
// z with expf (#13: e * (1 / z)), times the keep mask of dropout_hash.cuh
// (query row b * s_q + i, key j, op id op_base + h: attention.cuh's ids, so
// the keep masks are the same bits); the backward recomputes p, takes dp = (g
// v^T) * kappa, t = rowsum(dp * p), ds = p (dp - t) * scale. Every product is
// 3xTF32 in one f32 accumulator, held to IEEE f32 products within the
// measured error, not bit for bit; in f32 the TPU kernels' casts to the compute
// dtype are identities. Key columns past s_k are left out of the max and
// the sum (a fully masked sentence is uniform over its s_k keys), and query
// rows past s_q give zero P kappa and dS.
#pragma once

#include <cmath>
#include <cstdint>

#include "attention.cuh"
#include "dropout_hash.cuh"
#include "layer_common.cuh"

// Internal linkage in the including file's own anonymous namespace, as
// attention.cuh.
namespace {

using namespace kvq;

constexpr int ATTF_MAX_S = 32, ATTF_MAX_HD = 128;

using AttF32Args = AttnArgs<float>;  // attention_long.cuh

// One warp's shared memory, in floats: the q, k, v (and g) tiles, then in
// the backward the P kappa and dS tiles ((sqp, skp) at row stride tld), then
// the key mask (ATTF_MAX_S ints). In the backward the v tile has max(sqp,
// skp) rows: it stages dq, dk and dv.
struct AttF32Plan {
  int sqp, skp, hdp, ld;  // rows padded to 16 or 32, head_dim to 8s, ld = hdp + 4
  int tq, tk, tv;         // floats of a q (or g) tile, a k tile, a v tile
  int buf;                // floats of the q, k, v (and g) tiles
  int tld;                // row stride of the P kappa / dS tiles: skp + 4
  int bytes;              // a warp's bytes (a multiple of 16)
  int rpp, lr, lc;        // 16-byte path: rows a pass, this lane's first row and column
};

__host__ __device__ inline AttF32Plan attf_plan(int s_q, int s_k, int hd, bool bwd) {
  AttF32Plan p;
  p.sqp = s_q > 16 ? 32 : 16;
  p.skp = s_k > 16 ? 32 : 16;
  p.hdp = (hd + 7) & ~7;
  p.ld = p.hdp + 4;
  p.tq = p.sqp * p.ld;
  p.tk = p.skp * p.ld;
  p.tv = bwd && p.sqp > p.skp ? p.tq : p.tk;
  p.buf = p.tq + p.tk + p.tv + (bwd ? p.tq : 0);
  p.tld = p.skp + 4;
  p.bytes = (p.buf + (bwd ? 2 * p.sqp * p.tld : 0)) * 4 + ATTF_MAX_S * 4;
  return p;
}

// an A (16 x 8) or B (8 x 8) operand of mma.sync m16n8k8 tf32, split in two
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the small products first, then big * big
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.small, b.big[0], b.big[1]);
  mma_tf32(d, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

__device__ __forceinline__ void attf_split(FragA& f, const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32<true>(x[e], f.big[e], f.small[e]);
}

// A fragment at rows m0.., columns k0..k0 + 7 of a row-major tile (row
// stride ld): a0 (row g, column t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4), one ldmatrix.x4
__device__ __forceinline__ void attf_a_rows(FragA& f, const float* T, int ld, int m0, int k0,
                                            int lane) {
  const int mi = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, T + (m0 + (lane & 7) + ((mi & 1) << 3)) * ld + k0 + ((mi >> 1) << 2));
  const float x[4] = {__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                      __uint_as_float(r[3])};
  attf_split(f, x);
}

// B fragments of the n8 tiles at n0 and n0 + 8, k0..k0 + 7, of B = T^T for a
// row-major (n, k) tile: b0 (k t, n g) = T[n0 + g][k0 + t], b1 at k0 + t + 4
__device__ __forceinline__ void attf_b_rows(FragB (&f)[2], const float* T, int ld, int n0, int k0,
                                            int lane) {
  const int mi = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, T + (n0 + (lane & 7) + ((mi >> 1) << 3)) * ld + k0 + ((mi & 1) << 2));
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32<true>(__uint_as_float(r[e]), f[e >> 1].big[e & 1],
                                         f[e >> 1].small[e & 1]);
}

// B fragment (k0..k0 + 7, the n8 tile at n0) of a row-major (k, n) tile, k
// slot t at row k0 + 2t and slot t + 4 at row k0 + 2t + 1 (the accumulator's
// column order): a lane reads column n0 + g of two rows. With ld = 4 mod 8
// the rows 2t fall on banks 8 apart: no conflicts.
__device__ __forceinline__ void attf_b_pairs(FragB& f, const float* T, int ld, int k0, int n0,
                                             int lane) {
  const float* p = T + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  split_tf32<true>(p[0], f.big[0], f.small[0]);
  split_tf32<true>(p[ld], f.big[1], f.small[1]);
}

// A fragment (rows m0.., k0..k0 + 7) of the transpose of a row-major (k, m)
// tile, in the slot order of attf_b_pairs
__device__ __forceinline__ void attf_a_pairs(FragA& f, const float* T, int ld, int k0, int m0,
                                             int lane) {
  const float* p = T + (k0 + 2 * (lane & 3)) * ld + m0 + (lane >> 2);
  const float x[4] = {p[0], p[8], p[ld], p[ld + 8]};
  attf_split(f, x);
}

// the accumulator tile c (columns 8 kk..: c0 (g, 2t), c1 (g, 2t + 1), c2 (g +
// 8, 2t), c3 (g + 8, 2t + 1)) as the A fragment of k8 step kk, in the slot
// order of attf_b_pairs
__device__ __forceinline__ void attf_c_to_a(FragA& f, const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  attf_split(f, x);
}

// acc[mt][nt] += A[16 mt.., :] B[8 nt.., :]^T over the padded head dim, A and
// B row-major at row stride ld (the q / g tile and the k / v tile)
template <int MT, int KT>
__device__ __forceinline__ void attf_abt(float (&acc)[MT][2 * KT][4], const float* A,
                                         const float* B, const AttF32Plan& P, int lane) {
  for (int d0 = 0; d0 < P.hdp; d0 += 8) {
    FragA af[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) attf_a_rows(af[mt], A, P.ld, mt * 16, d0, lane);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      FragB bf[2];
      attf_b_rows(bf, B, P.ld, kt * 16, d0, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma3(acc[mt][2 * kt], af[mt], bf[0]);
        mma3(acc[mt][2 * kt + 1], af[mt], bf[1]);
      }
    }
  }
}

// out rows (MB m16 blocks, the first `rows` real) = A (registers, KS k8
// steps of the attf_b_pairs order) times the row-major (k, n) tile X, an n8
// tile of columns at a time, staged into st (row stride ld, columns < hd)
template <int MB, int KS>
__device__ __forceinline__ void attf_mix(float* st, const FragA (&a)[MB][KS], const float* X,
                                         const AttF32Plan& P, int rows, int hd, int lane) {
  const int g8 = lane >> 2, t4 = lane & 3;
  for (int n0 = 0; n0 < P.hdp; n0 += 8) {
    float o[MB][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      FragB b;
      attf_b_pairs(b, X, P.ld, ks * 8, n0, lane);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) mma3(o[mb], a[mb][ks], b);
    }
    const int d = n0 + 2 * t4;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = mb * 16 + g8 + 8 * r;
        if (i >= rows) continue;
        if (d + 1 < hd)
          *reinterpret_cast<float2*>(st + i * P.ld + d) =
              make_float2(o[mb][2 * r], o[mb][2 * r + 1]);
        else if (d < hd)
          st[i * P.ld + d] = o[mb][2 * r];
      }
  }
}

// rows x hd of src (row stride src_ld) into a tile (row stride P.ld): 16-byte
// cp.async (VEC: hd, src_ld and src 16-byte aligned), P.rpp rows a pass,
// this lane's chunk at row P.lr, column P.lc of each (no division in the
// loop); or element copies
template <bool VEC>
__device__ __forceinline__ void attf_load(float* dst, const float* src, int src_ld, int rows,
                                          int hd, const AttF32Plan& P, int lane) {
  if constexpr (VEC) {
    if (P.lr < P.rpp)
      for (int r = P.lr; r < rows; r += P.rpp)
        cp_async16(dst + r * P.ld + P.lc, src + (size_t)r * src_ld + P.lc, true);
  } else {
    for (int r = 0; r < rows; ++r)
      for (int c = lane; c < hd; c += 32) dst[r * P.ld + c] = src[(size_t)r * src_ld + c];
  }
}

// rows x hd of a staged tile (row stride P.ld) out to dst (row stride dst_ld),
// as attf_load reads
template <bool VEC>
__device__ __forceinline__ void attf_store(float* dst, int dst_ld, const float* src, int rows,
                                           int hd, const AttF32Plan& P, int lane) {
  if constexpr (VEC) {
    if (P.lr < P.rpp)
      for (int r = P.lr; r < rows; r += P.rpp)
        *reinterpret_cast<float4*>(dst + (size_t)r * dst_ld + P.lc) =
            *reinterpret_cast<const float4*>(src + r * P.ld + P.lc);
  } else {
    for (int r = 0; r < rows; ++r)
      for (int c = lane; c < hd; c += 32) dst[(size_t)r * dst_ld + c] = src[r * P.ld + c];
  }
}

// Start the loads of unit u (sentence u / nh, head u % nh) into the warp's tiles.
template <bool VEC, bool BWD>
__device__ __forceinline__ void attf_fetch(const AttF32Args& a, const AttF32Plan& P, float* buf,
                                           int* msk, int u, int lane) {
  const int b = u / a.nh, h = u - b * a.nh;
  const size_t col = (size_t)h * a.hd;
  float* ks = buf + P.tq;
  float* vs = ks + P.tk;
  attf_load<VEC>(buf, a.q + (size_t)b * a.s_q * a.q_ld + col, a.q_ld, a.s_q, a.hd, P, lane);
  attf_load<VEC>(ks, a.k + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, a.s_k, a.hd, P, lane);
  attf_load<VEC>(vs, a.v + (size_t)b * a.s_k * a.kv_ld + col, a.kv_ld, a.s_k, a.hd, P, lane);
  if constexpr (BWD) {
    const int H = a.nh * a.hd;
    attf_load<VEC>(vs + P.tv, a.g + (size_t)b * a.s_q * H + col, H, a.s_q, a.hd, P, lane);
  }
  if (a.key_mask != nullptr && lane < a.s_k) cp_async4(msk + lane, a.key_mask + b * a.s_k + lane);
}

// Forward of one unit from its tiles: ctx rows of the sentence, head h.
template <bool WHERE_MASK, bool VEC, int MT, int KT>
__device__ __forceinline__ void attf_unit(const AttF32Args& a, const AttF32Plan& P, float* buf,
                                          const int* msk, int u, int lane) {
  const int b = u / a.nh, h = u - b * a.nh;
  float* qs = buf;
  const float* ks = qs + P.tq;
  const float* vs = ks + P.tk;
  const int g8 = lane >> 2, t4 = lane & 3;

  float s[MT][2 * KT][4] = {};
  attf_abt<MT, KT>(s, qs, ks, P, lane);

  // softmax as e / z (#13: e * (1 / z)), times the keep mask, then P kappa
  // as A fragments
  FragA pa[MT][2 * KT];
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
    for (int nt = 0; nt < 2 * KT; ++nt) attf_c_to_a(pa[mt][nt], s[mt][nt]);
  }

  // ctx = (p kappa) v, staged in the spent q tile
  __syncwarp();
  attf_mix(qs, pa, vs, P, a.s_q, a.hd, lane);
  __syncwarp();
  attf_store<VEC>(a.out + (size_t)b * a.s_q * a.out_ld + (size_t)h * a.hd, a.out_ld, qs, a.s_q,
                  a.hd, P, lane);
}

// Backward of one unit, recomputing the probabilities from q and k:
//   p = softmax(q k^T * scale + bias), kappa = keep mask (op_base + h)
//   dp = (g v^T) * kappa;  t = rowsum(dp * p);  ds = p (dp - t) * scale
//   dq = ds k;  dk = ds^T q;  dv = (p kappa)^T g
// with g the context gradient, each written through the spent v tile.
template <bool VEC, int MT, int KT>
__device__ __forceinline__ void attf_bwd_unit(const AttF32Args& a, const AttF32Plan& P,
                                              float* buf, const int* msk, float* pk, float* dst,
                                              int u, int lane) {
  const int b = u / a.nh, h = u - b * a.nh;
  const float* qs = buf;
  const float* ks = qs + P.tq;
  float* vs = buf + P.tq + P.tk;
  const float* gs = vs + P.tv;
  const int g8 = lane >> 2, t4 = lane & 3;

  float s[MT][2 * KT][4] = {}, dp[MT][2 * KT][4] = {};
  attf_abt<MT, KT>(s, qs, ks, P, lane);
  attf_abt<MT, KT>(dp, gs, vs, P, lane);

  // per query row: p, dp * kappa, p * kappa into pk, t, then ds (registers and dst)
  FragA dsa[MT][2 * KT];
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
        *reinterpret_cast<float2*>(pk + i * P.tld + nt * 8 + 2 * t4) = make_float2(pd[0], pd[1]);
      }
      t = quad_sum(t);
#pragma unroll
      for (int nt = 0; nt < 2 * KT; ++nt) {
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          ds[c] = s[mt][nt][2 * r + c] * (dp[mt][nt][2 * r + c] - t) * a.scale;
          dp[mt][nt][2 * r + c] = ds[c];
        }
        *reinterpret_cast<float2*>(dst + i * P.tld + nt * 8 + 2 * t4) = make_float2(ds[0], ds[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2 * KT; ++nt) attf_c_to_a(dsa[mt][nt], dp[mt][nt]);
  }
  __syncwarp();  // pk and dst are written; v is spent

  // dq = ds k (ds from registers)
  attf_mix(vs, dsa, ks, P, a.s_q, a.hd, lane);
  __syncwarp();
  attf_store<VEC>(a.out + (size_t)b * a.s_q * a.out_ld + (size_t)h * a.hd, a.out_ld, vs, a.s_q,
                  a.hd, P, lane);
  __syncwarp();  // k is spent

  // dk = ds^T q and dv = (p kappa)^T g: rows are keys, the sum runs over queries
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* T = which == 0 ? dst : pk;
    const float* X = which == 0 ? qs : gs;
    float* out = which == 0 ? a.dk : a.dv;
    FragA at[KT][2 * MT];  // [key block][query k8 step]
#pragma unroll
    for (int mk = 0; mk < KT; ++mk)
#pragma unroll
      for (int kq = 0; kq < 2 * MT; ++kq) attf_a_pairs(at[mk][kq], T, P.tld, kq * 8, mk * 16, lane);
    attf_mix(vs, at, X, P, a.s_k, a.hd, lane);
    __syncwarp();
    attf_store<VEC>(out + (size_t)b * a.s_k * a.dkv_ld + (size_t)h * a.hd, a.dkv_ld, vs, a.s_k,
                    a.hd, P, lane);
    __syncwarp();
  }
}

// The persistent loop of one warp over its units.
template <bool BWD, bool WHERE_MASK, bool VEC, int MT, int KT>
__device__ __forceinline__ void attf_walk(const AttF32Args& a, unsigned char* smem) {
  AttF32Plan P = attf_plan(a.s_q, a.s_k, a.hd, BWD);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  if constexpr (VEC) {
    const int cpr = a.hd >> 2;  // 16-byte chunks a row, at most 32 (hd <= 128)
    P.rpp = 32 / cpr;
    P.lr = lane / cpr;
    P.lc = (lane - P.lr * cpr) << 2;
  }
  float* buf = reinterpret_cast<float*>(smem + (size_t)warp * P.bytes);
  float* pk = buf + P.buf;  // backward only
  float* dst = pk + P.sqp * P.tld;
  int* msk = reinterpret_cast<int*>(smem + (size_t)(warp + 1) * P.bytes) - ATTF_MAX_S;
  att_zero(buf, P.bytes, lane);
  __syncwarp();

  const int total = a.batch * a.nh, stride = gridDim.x * nw;
  for (int u = blockIdx.x * nw + warp; u < total; u += stride) {
    attf_fetch<VEC, BWD>(a, P, buf, msk, u, lane);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    if constexpr (BWD)
      attf_bwd_unit<VEC, MT, KT>(a, P, buf, msk, pk, dst, u, lane);
    else
      attf_unit<WHERE_MASK, VEC, MT, KT>(a, P, buf, msk, u, lane);
    __syncwarp();  // every lane is done with the tiles before they take new loads
  }
}

// MT / KT: the m16 blocks of queries / keys (1 for up to 16 rows, 2 for up
// to 32).
template <bool BWD, bool WHERE_MASK, bool VEC, int MT, int KT>
__global__ void __launch_bounds__(32 * ATT_WARPS) attention_f32_kernel(AttF32Args a) {
  extern __shared__ __align__(16) unsigned char attf_smem[];
  attf_walk<BWD, WHERE_MASK, VEC, MT, KT>(a, attf_smem);
}

inline bool attention_f32_fits(int s_q, int s_k, int head_dim) {
  return s_q >= 1 && s_k >= 1 && s_q <= ATTF_MAX_S && s_k <= ATTF_MAX_S && head_dim >= 1 &&
         head_dim <= ATTF_MAX_HD;
}

// the instance for the call's tiles (16 or 32 rows of queries and of keys)
template <bool BWD, bool WHERE_MASK, bool VEC>
int attf_launch_for(const AttF32Args& a, cudaStream_t st) {
  const int bytes = attf_plan(a.s_q, a.s_k, a.hd, BWD).bytes;
  switch ((a.s_q > 16) * 2 + (a.s_k > 16)) {
    case 0:
      return att_launch<AttF32Args, attention_f32_kernel<BWD, WHERE_MASK, VEC, 1, 1>>(a, bytes, st);
    case 1:
      return att_launch<AttF32Args, attention_f32_kernel<BWD, WHERE_MASK, VEC, 1, 2>>(a, bytes, st);
    case 2:
      return att_launch<AttF32Args, attention_f32_kernel<BWD, WHERE_MASK, VEC, 2, 1>>(a, bytes, st);
    default:
      return att_launch<AttF32Args, attention_f32_kernel<BWD, WHERE_MASK, VEC, 2, 2>>(a, bytes, st);
  }
}

template <bool BWD, bool WHERE_MASK = false>
int attf_launch(const AttF32Args& a, cudaStream_t st) {
  if (!attention_short(a.s_q, a.s_k) || a.hd > ATTF_MAX_HD) {  // past 32 tokens or 128 columns
    if constexpr (BWD)
      return attention_long_bwd(a, st);
    else
      return attention_long_fwd(a, WHERE_MASK, st);
  }
  if (!attention_f32_fits(a.s_q, a.s_k, a.hd)) return static_cast<int>(cudaErrorInvalidValue);
  return att_vec(a, BWD) ? attf_launch_for<BWD, WHERE_MASK, true>(a, st)
                         : attf_launch_for<BWD, WHERE_MASK, false>(a, st);
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
// given its gradient g (batch*s_q contiguous rows of nh*hd), all f32; stats:
// the 64-row tiles' scratch (null up to 32 queries and keys, at any
// head_dim). A template, so that a file that does not launch it compiles
// none of it.
template <int UNUSED = 0>
inline int attention_f32_bwd(const void* q, int q_ld, const void* k, const void* v, int kv_ld,
                             const int* mask, const void* g, void* dq, int dq_ld, void* dk,
                             void* dv, int dkv_ld, int batch, int nh, int hd, int s_q, int s_k,
                             int causal, DropoutParams drop, int op_base, float* stats,
                             cudaStream_t st) {
  const AttF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), mask, static_cast<const float*>(g),
                     static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                     q_ld, kv_ld, dq_ld, dkv_ld, batch, nh, hd, s_q, s_k, causal, op_base,
                     1.0f / sqrtf(static_cast<float>(hd)), drop, stats};
  return attf_launch<true>(a, st);
}

}  // namespace
