// Streaming cross-entropy over bf16 or f32 logits for Hopper (sm_90a).
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
//             written in the logits' type
//
// What bounds it on the H100: bytes. Each pass reads the 1.5 GB of logits
// once (the backward also writes 1.5 GB), 0.448 ms at 3.35 TB/s for the
// forward, 0.896 for the backward. A per-element online softmax (a branch,
// an expf on either path, an argmax compare and a target compare: 15-20
// instructions over 750 M elements) costs as much instruction time as the bytes
// take, so both directions work on 16-byte chunks:
// - a row is a scalar head up to its first 16-byte boundary (rows of
//   30,522 bf16 start at four 16-byte phases, of GPT-2's 50,257 at all
//   eight), a body of 16-byte loads of 8 bf16 or 4 f32, and a scalar tail,
//   so every row phase, any vocabulary and either dtype take the same path
//   with no padded copy of the logits; the forward takes a warp a row, 8
//   rows a block, four loads in flight a lane; the backward a 256-thread
//   block a row, eight loads in flight a thread to the row's end (of the
//   probes on the H100, the fastest at 83-87% of its byte bound, where a
//   device copy of the same bytes reaches 91%; a warp a row with four in
//   flight took 2-4% longer, streaming stores gained nothing, PERF.md);
// - the exps are `ex2.approx` of x * log2(e) - m * log2(e) (one FMA and one
//   MUFU op an element, the scaled max or lse rounded once), within a few
//   1e-6 relative of a libm expf, which costs some 20 instructions;
// - forward, per chunk as the TPU kernel does per tile (ce_pallas.py:82-86):
//   its max from 7 fmaxf, one rescale of the running sum when the max
//   grows, then its exps; the scaled max is rounded once a new max, and lse
//   = (m * log2(e) + log2(s)) * ln 2: the NLL stays within a few 1e-6 of
//   the plain f32 version's at |x| ~ 40, against CE_NLL_ABS 1e-4;
// - the argmax rides on the running max: a chunk whose max beats it
//   (strict >) looks for its first index of that value, so a lane keeps its
//   lowest index; lanes merge by the larger value and, on equal values, the
//   lower index;
// - lane 0 reads x[row, target] once (0 outside the vocabulary, as
//   `target_logits` does): no compare an element;
// - backward: the output row starts at the logits row's 16-byte phase (the
//   wrapper allocates it so: a model's logits start at offset 0, and their
//   gradient then does too, as cuBLAS's dgrad wants), so a body chunk is
//   one 16-byte load and one 16-byte store; the target is tested once a
//   chunk, and its element keeps the plain version's (p - 1) * scale.
// #6 and #7 are one template: the flag IDS drops the argmax state, so the
// two share every other line and give the same NLL bits.
//
// f32 logits (an f32 run: JAX's parity dtype, in which its Pallas kernels
// run too) take the same kernels instantiated on float: a 16-byte chunk is 4
// f32, rows of 30,522 f32 (122,088 bytes, 8 mod 16) start at two 16-byte
// phases and rows of GPT-2's 50,257 at four.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int CE_ROWS = 8;       // the forward: a warp a row, 8 rows a block
constexpr int CE_THREADS = 256;  // the backward: a block a row
constexpr int BWD_DEPTH = 8;     // the backward: 16-byte loads in flight a thread
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

// the 16-byte chunk of the body at columns c0..: 8 bf16 or 4 f32
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    x[2 * k] = t.x;
    x[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x), x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z), x[3] = __uint_as_float(u.w);
}

template <bool IDS, typename T>
__device__ __forceinline__ void take_chunk(Online& st, const uint4& u, int c0) {
  constexpr int E = 16 / sizeof(T);
  float x[E];
  unpack(u, x);
  float cm = x[0];
#pragma unroll
  for (int k = 1; k < E; ++k) cm = fmaxf(cm, x[k]);
  if (cm > st.m) {
    raise_max(st, cm);
    if constexpr (IDS) {
      int j = E - 1;
#pragma unroll
      for (int k = E - 2; k >= 0; --k) j = x[k] == cm ? k : j;  // the chunk's first index of cm
      st.bi = c0 + j;
    }
  }
  if (st.m == -INFINITY) return;  // nothing but -inf so far: no mass
  float a = 0.0f;
#pragma unroll
  for (int k = 0; k < E; ++k) a += ex2(fmaf(x[k], LOG2E, -st.mL));
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

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(bf16& o, float v) { o = __float2bfloat16(v); }
__device__ __forceinline__ void from_f32(float& o, float v) { o = v; }

// IDS: #7 (nll and ids); otherwise #6 (nll alone, ids unused). T: the
// logits' type, bf16 or float.
template <bool IDS, typename T>
__global__ void __launch_bounds__(32 * CE_ROWS)
ce_fwd_kernel(const T* __restrict__ logits, int rows, int vocab,
              const int* __restrict__ targets, float* __restrict__ nll, int* __restrict__ ids) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte chunk
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * CE_ROWS + threadIdx.x / 32;
  if (row >= rows) return;
  const T* x = logits + (size_t)row * vocab;
  // the head: the elements before the row's first 16-byte boundary
  int head = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(x) & 15u)) & 15u) / sizeof(T));
  head = head < vocab ? head : vocab;
  const int body = (vocab - head) / E, tail = head + E * body;
  Online st{-INFINITY, -INFINITY, 0.0f, INT_MAX};
  if (lane < head) take1<IDS>(st, to_f32(x[lane]), lane);
  const uint4* xb = reinterpret_cast<const uint4*>(x + head);
  int c = lane;
  for (; c + 96 < body; c += 128) {
    const uint4 u0 = __ldg(xb + c), u1 = __ldg(xb + c + 32), u2 = __ldg(xb + c + 64),
                u3 = __ldg(xb + c + 96);
    take_chunk<IDS, T>(st, u0, head + E * c);
    take_chunk<IDS, T>(st, u1, head + E * (c + 32));
    take_chunk<IDS, T>(st, u2, head + E * (c + 64));
    take_chunk<IDS, T>(st, u3, head + E * (c + 96));
  }
  for (; c < body; c += 32) take_chunk<IDS, T>(st, __ldg(xb + c), head + E * c);
  if (tail + lane < vocab) take1<IDS>(st, to_f32(x[tail + lane]), tail + lane);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) merge_xor<IDS>(st, o);
  if (lane == 0) {
    const int tgt = targets[row];
    const float t = tgt >= 0 && tgt < vocab ? to_f32(x[tgt]) : 0.0f;
    nll[row] = fmaf(st.mL + log2f(st.s), LN2, -t);
    if constexpr (IDS) ids[row] = st.bi == INT_MAX ? 0 : st.bi;  // a row of -inf: index 0
  }
}

// one element of the gradient: p = 2^(x log2(e) - lse log2(e)), the one-hot
// subtracted at the target and the row's scale applied last, the plain
// version's order
__device__ __forceinline__ float grad1(float x, float lL, bool hit, float sc) {
  const float p = ex2(fmaf(x, LOG2E, -lL));
  return (hit ? p - 1.0f : p) * sc;
}

__device__ __forceinline__ uint4 pack(const float (&g)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(g[2 * k], g[2 * k + 1]);
  return u;
}

__device__ __forceinline__ uint4 pack(const float (&g)[4]) {
  return make_uint4(__float_as_uint(g[0]), __float_as_uint(g[1]), __float_as_uint(g[2]),
                    __float_as_uint(g[3]));
}

// the gradient of a 16-byte chunk; kt is the target's place in it (outside
// [0, E) when the chunk does not hold it), tested once a chunk
template <typename T>
__device__ __forceinline__ uint4 grad_chunk(const uint4& u, int kt, float lL, float sc) {
  constexpr int E = 16 / sizeof(T);
  float g[E];
  unpack(u, g);
#pragma unroll
  for (int k = 0; k < E; ++k) g[k] = ex2(fmaf(g[k], LOG2E, -lL));
  if (static_cast<unsigned>(kt) < E) {
#pragma unroll
    for (int k = 0; k < E; ++k) g[k] = k == kt ? g[k] - 1.0f : g[k];
  }
#pragma unroll
  for (int k = 0; k < E; ++k) g[k] *= sc;
  return pack(g);
}

// #8: a block a row, the row cut as ce_fwd_kernel cuts it, each thread
// keeping BWD_DEPTH 16-byte loads in flight to the row's end; out shares the
// logits' 16-byte phase (kvq_ce_bwd checks it), so each body chunk is one
// 16-byte load and one 16-byte store
template <typename T>
__global__ void __launch_bounds__(CE_THREADS)
ce_bwd_kernel(const T* __restrict__ logits, int vocab, const int* __restrict__ targets,
              const float* __restrict__ lse, const float* __restrict__ scale,
              T* __restrict__ out) {
  constexpr int E = 16 / sizeof(T), L = CE_THREADS, D = BWD_DEPTH;
  const int lane = threadIdx.x, row = blockIdx.x;
  const T* x = logits + (size_t)row * vocab;
  T* o = out + (size_t)row * vocab;
  int head = static_cast<int>(((16u - (reinterpret_cast<uintptr_t>(x) & 15u)) & 15u) / sizeof(T));
  head = head < vocab ? head : vocab;
  const int body = (vocab - head) / E, tail = head + E * body;
  const int tgt = targets[row];
  const float lL = lse[row] * LOG2E, sc = scale[row];
  if (lane < head) from_f32(o[lane], grad1(to_f32(x[lane]), lL, lane == tgt, sc));
  const uint4* xb = reinterpret_cast<const uint4*>(x + head);
  uint4* ob = reinterpret_cast<uint4*>(o + head);
  const int kt = tgt - head;  // the target's column counted from the body
  for (int c = lane; c < body; c += D * L) {
    uint4 u[D];
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (c + k * L < body) u[k] = __ldg(xb + c + k * L);
#pragma unroll
    for (int k = 0; k < D; ++k)
      if (c + k * L < body) ob[c + k * L] = grad_chunk<T>(u[k], kt - E * (c + k * L), lL, sc);
  }
  const int ct = tail + lane;
  if (ct < vocab) from_f32(o[ct], grad1(to_f32(x[ct]), lL, ct == tgt, sc));
}

template <bool IDS, typename T>
int launch_fwd(const void* logits, const int* targets, void* nll, void* ids, int rows, int vocab,
               void* stream) {
  ce_fwd_kernel<IDS, T><<<(rows + CE_ROWS - 1) / CE_ROWS, 32 * CE_ROWS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), rows, vocab, targets, static_cast<float*>(nll),
      static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* logits, const int* targets, const void* lse, const void* scale,
               void* out, int rows, int vocab, void* stream) {
  ce_bwd_kernel<T><<<rows, CE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), vocab, targets, static_cast<const float*>(lse),
      static_cast<const float*>(scale), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// logits (rows, vocab) row-major, f32 when f32, else bf16; targets (rows,)
// int32; nll (rows,) f32 and ids (rows,) int32 written.
int kvq_ce_fwd_ids(const void* logits, const int* targets, void* nll, void* ids, int rows,
                   int vocab, int f32, void* stream) {
  if (rows <= 0) return 0;
  return f32 ? launch_fwd<true, float>(logits, targets, nll, ids, rows, vocab, stream)
             : launch_fwd<true, bf16>(logits, targets, nll, ids, rows, vocab, stream);
}

// As kvq_ce_fwd_ids without the argmax: nll (rows,) f32 written.
int kvq_ce_fwd(const void* logits, const int* targets, void* nll, int rows, int vocab, int f32,
               void* stream) {
  if (rows <= 0) return 0;
  return f32 ? launch_fwd<false, float>(logits, targets, nll, nullptr, rows, vocab, stream)
             : launch_fwd<false, bf16>(logits, targets, nll, nullptr, rows, vocab, stream);
}

// out (rows, vocab), the logits' type, = (softmax(logits) - one_hot(targets))
// * scale[:, None], with softmax from the per-row lse (f32). out starts at
// the logits' 16-byte phase (cudaErrorInvalidValue otherwise).
int kvq_ce_bwd(const void* logits, const int* targets, const void* lse, const void* scale,
               void* out, int rows, int vocab, int f32, void* stream) {
  if (rows <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(logits) ^ reinterpret_cast<uintptr_t>(out)) & 15u)
    return static_cast<int>(cudaErrorInvalidValue);
  return f32 ? launch_bwd<float>(logits, targets, lse, scale, out, rows, vocab, stream)
             : launch_bwd<bf16>(logits, targets, lse, scale, out, rows, vocab, stream);
}

}  // extern "C"
