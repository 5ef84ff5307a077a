// Streaming cross-entropy over bf16 logits for Hopper (sm_90a).
//
// Replaces kindergarten_vq_vae_tpu/ops/ce_pallas.py `_ce_fwd_kernel` (l.34),
// `_ce_fwd_ids_kernel` (l.63) and `_ce_bwd_kernel` (l.104), the
// reconstruction loss of the training step over (rows, vocab) =
// (24576, 30522) bf16 logits at batch 2048 x 12:
//
//   forward   nll[r] = logsumexp(x[r, :]) - x[r, target[r]]  (f32), and with
//             ids (#7) ids[r] = argmax(x[r, :]), the lowest index among equal
//             maxima (jnp.argmax / the TPU kernel's first-max rule across
//             blocks); without ids (#6) the same NLL alone
//   backward  dx[r, c] = (exp(x[r, c] - lse[r]) - [c == target[r]]) * scale[r]
//             written in bf16
//
// What bounds it on the H100: bytes. Each pass reads the 1.5 GB of logits
// once (the backward also writes 1.5 GB), 0.448 ms at 3.35 TB/s for the
// forward. A per-element online softmax (a branch, an expf on either path, an
// argmax compare and a target compare: 15-20 instructions over 750 M
// elements) costs as much issue time as the bytes take, so the forward
// works on 16-byte chunks:
// - one warp a row, 8 rows a block; a row is a scalar head up to its first
//   16-byte boundary (rows of 30,522 bf16 start at four 16-byte phases), a
//   body of 16-byte loads of 8 bf16, four in flight a lane, and a scalar
//   tail, so every row phase and an odd vocabulary take the same path with
//   no padded copy of the logits;
// - per chunk, as the TPU kernel does per tile (ce_pallas.py:82-86): its
//   max from 7 fmaxf, one rescale of the running sum when the max grows,
//   then its 8 exps. The exps are `ex2.approx` of x * log2(e) - m * log2(e)
//   (one FMA and one MUFU op an element; the scaled max is rounded once a
//   new max, and lse = (m * log2(e) + log2(s)) * ln 2): the NLL stays within
//   a few 1e-6 of the plain f32 version's at |x| ~ 40, against CE_NLL_ABS
//   1e-4, where a libm expf costs some 20 instructions an element;
// - the argmax rides on the running max: a chunk whose max beats it
//   (strict >) looks for its first index of that value, so a lane keeps its
//   lowest index; lanes merge by the larger value and, on equal values, the
//   lower index;
// - lane 0 reads x[row, target] once (0 outside the vocabulary, as
//   `target_logits` does): no compare an element.
// The backward streams a row per block with bf16 pairs (elements where the
// vocabulary is odd or a buffer is not 4-byte aligned). #6 and #7 are one
// template: the flag IDS drops the argmax state, so the two share every
// other line and give the same NLL bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int CE_THREADS = 256;  // backward: a block a row
constexpr int CE_ROWS = 8;       // forward: a warp a row, 8 rows a block
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// A lane's (then a row's) running state: max m (which is also the best
// value of the argmax), mL = RN(m * log2(e)), s = sum of 2^(x log2(e) - mL),
// bi the lowest index of m (IDS only).
struct Online {
  float m, mL, s;
  int bi;
};

__device__ __forceinline__ void raise_max(Online& st, float m) {
  const float mL = m * LOG2E;
  st.s *= ex2(st.mL - mL);  // 0 while nothing has been seen (mL -inf, s 0)
  st.m = m;
  st.mL = mL;
}

// one element at column c (the row's head and tail)
template <bool IDS>
__device__ __forceinline__ void take1(Online& st, float x, int c) {
  if (x > st.m) {
    raise_max(st, x);
    if constexpr (IDS) st.bi = c;
  }
  if (st.m != -INFINITY) st.s += ex2(fmaf(x, LOG2E, -st.mL));
}

// eight elements at columns c0..c0+7 (a 16-byte chunk of the body)
template <bool IDS>
__device__ __forceinline__ void take8(Online& st, const uint4& u, int c0) {
  float x[8];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    x[2 * k] = t.x;
    x[2 * k + 1] = t.y;
  }
  const float cm = fmaxf(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])),
                         fmaxf(fmaxf(x[4], x[5]), fmaxf(x[6], x[7])));
  if (cm > st.m) {
    raise_max(st, cm);
    if constexpr (IDS) {
      int j = 7;
#pragma unroll
      for (int k = 6; k >= 0; --k) j = x[k] == cm ? k : j;  // the chunk's first index of cm
      st.bi = c0 + j;
    }
  }
  if (st.m == -INFINITY) return;  // nothing but -inf so far: no mass
  float a = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) a += ex2(fmaf(x[k], LOG2E, -st.mL));
  st.s += a;
}

// a with the state of lane ^ o merged in: the larger max rescales the other
// sum; the argmax takes the larger value and, on equal values, the lower
// index. Each case computes the same expression from either side, so every
// lane of the butterfly ends with the same bits.
template <bool IDS>
__device__ __forceinline__ void merge_xor(Online& a, int o) {
  const float bm = __shfl_xor_sync(0xffffffffu, a.m, o);
  const float bmL = __shfl_xor_sync(0xffffffffu, a.mL, o);
  const float bs = __shfl_xor_sync(0xffffffffu, a.s, o);
  if constexpr (IDS) {
    const int bbi = __shfl_xor_sync(0xffffffffu, a.bi, o);
    if (bm > a.m || (bm == a.m && bbi < a.bi)) a.bi = bbi;
  }
  if (bm > a.m) {
    a.s = a.m == -INFINITY ? bs : fmaf(a.s, ex2(a.mL - bmL), bs);
    a.m = bm;
    a.mL = bmL;
  } else if (bm == a.m) {
    a.s += bs;
  } else if (bm != -INFINITY) {
    a.s = fmaf(bs, ex2(bmL - a.mL), a.s);
  }
}

// IDS: #7 (nll and ids); otherwise #6 (nll alone, ids unused).
template <bool IDS>
__global__ void __launch_bounds__(32 * CE_ROWS)
ce_fwd_kernel(const bf16* __restrict__ logits, int rows, int vocab,
              const int* __restrict__ targets, float* __restrict__ nll, int* __restrict__ ids) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * CE_ROWS + threadIdx.x / 32;
  if (row >= rows) return;
  const bf16* x = logits + (size_t)row * vocab;
  // the head: the elements before the row's first 16-byte boundary
  int head = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(x) & 15u)) & 15u) >> 1);
  head = head < vocab ? head : vocab;
  const int body = (vocab - head) >> 3, tail = head + 8 * body;
  Online st{-INFINITY, -INFINITY, 0.0f, INT_MAX};
  if (lane < head) take1<IDS>(st, __bfloat162float(x[lane]), lane);
  const uint4* xb = reinterpret_cast<const uint4*>(x + head);
  int c = lane;
  for (; c + 96 < body; c += 128) {
    const uint4 u0 = __ldg(xb + c), u1 = __ldg(xb + c + 32), u2 = __ldg(xb + c + 64),
                u3 = __ldg(xb + c + 96);
    take8<IDS>(st, u0, head + 8 * c);
    take8<IDS>(st, u1, head + 8 * (c + 32));
    take8<IDS>(st, u2, head + 8 * (c + 64));
    take8<IDS>(st, u3, head + 8 * (c + 96));
  }
  for (; c < body; c += 32) take8<IDS>(st, __ldg(xb + c), head + 8 * c);
  if (tail + lane < vocab) take1<IDS>(st, __bfloat162float(x[tail + lane]), tail + lane);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) merge_xor<IDS>(st, o);
  if (lane == 0) {
    const int tgt = targets[row];
    const float t = tgt >= 0 && tgt < vocab ? __bfloat162float(x[tgt]) : 0.0f;
    nll[row] = fmaf(st.mL + log2f(st.s), LN2, -t);
    if constexpr (IDS) ids[row] = st.bi == INT_MAX ? 0 : st.bi;  // a row of -inf: index 0
  }
}

__global__ void __launch_bounds__(CE_THREADS)
ce_bwd_kernel(const bf16* __restrict__ logits, int vocab, const int* __restrict__ targets,
              const float* __restrict__ lse, const float* __restrict__ scale,
              bf16* __restrict__ out) {
  const int row = blockIdx.x, tid = threadIdx.x;
  const size_t base = (size_t)row * vocab;
  const int tgt = targets[row];
  const float l = lse[row], sc = scale[row];
  // bf16 pairs need 4-byte aligned rows: an even vocabulary and 4-byte
  // aligned buffers (a view that starts at an odd element takes the element
  // path)
  const bool pairs = (vocab & 1) == 0 &&
                     ((reinterpret_cast<uintptr_t>(logits) | reinterpret_cast<uintptr_t>(out)) &
                      3u) == 0;
  if (pairs) {
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(logits + base);
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(out + base);
    for (int p = tid; p < vocab / 2; p += CE_THREADS) {
      const float2 v = __bfloat1622float2(x2[p]);
      const float g0 = (expf(v.x - l) - (2 * p == tgt ? 1.0f : 0.0f)) * sc;
      const float g1 = (expf(v.y - l) - (2 * p + 1 == tgt ? 1.0f : 0.0f)) * sc;
      o2[p] = __floats2bfloat162_rn(g0, g1);
    }
  } else {
    for (int c = tid; c < vocab; c += CE_THREADS) {
      const float v = __bfloat162float(logits[base + c]);
      out[base + c] = __float2bfloat16((expf(v - l) - (c == tgt ? 1.0f : 0.0f)) * sc);
    }
  }
}

}  // namespace

extern "C" {

// logits (rows, vocab) bf16 row-major; targets (rows,) int32; nll (rows,)
// f32 and ids (rows,) int32 written.
int kvq_ce_fwd_ids(const void* logits, const int* targets, void* nll, void* ids, int rows,
                   int vocab, void* stream) {
  if (rows <= 0) return 0;
  ce_fwd_kernel<true><<<(rows + CE_ROWS - 1) / CE_ROWS, 32 * CE_ROWS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(logits), rows, vocab, targets, static_cast<float*>(nll),
      static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

// As kvq_ce_fwd_ids without the argmax: nll (rows,) f32 written.
int kvq_ce_fwd(const void* logits, const int* targets, void* nll, int rows, int vocab,
               void* stream) {
  if (rows <= 0) return 0;
  ce_fwd_kernel<false><<<(rows + CE_ROWS - 1) / CE_ROWS, 32 * CE_ROWS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(logits), rows, vocab, targets, static_cast<float*>(nll), nullptr);
  return static_cast<int>(cudaGetLastError());
}

// out (rows, vocab) bf16 = (softmax(logits) - one_hot(targets)) * scale[:, None],
// with softmax from the per-row lse (f32).
int kvq_ce_bwd(const void* logits, const int* targets, const void* lse, const void* scale,
               void* out, int rows, int vocab, void* stream) {
  if (rows <= 0) return 0;
  ce_bwd_kernel<<<rows, CE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(logits), vocab, targets, static_cast<const float*>(lse),
      static_cast<const float*>(scale), static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
