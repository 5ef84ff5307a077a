// Streaming cross-entropy over bf16 logits for Hopper (sm_90a).
//
// Replaces kindergarten_vq_vae_tpu/ops/ce_pallas.py `_ce_fwd_ids_kernel`
// (l.63) and `_ce_bwd_kernel` (l.104), the reconstruction loss of the
// training step over (rows, vocab) = (24576, 30522) bf16 logits at batch
// 2048 x 12:
//
//   forward   nll[r] = logsumexp(x[r, :]) - x[r, target[r]]  (f32) and
//             ids[r] = argmax(x[r, :]), the lowest index among equal maxima
//             (jnp.argmax / the TPU kernel's first-max rule across blocks)
//   backward  dx[r, c] = (exp(x[r, c] - lse[r]) - [c == target[r]]) * scale[r]
//             written in bf16
//
// What bounds it on the H100: bytes. Each pass reads the 1.5 GB of logits
// once (the backward also writes 1.5 GB); the arithmetic is one exp per
// element. One block streams one row with an online max / sum-exp, a target
// gather and a running (value, index) argmax in registers, then combines its
// threads' states by a tree (ties keep the lower index). The TPU kernel
// walked vocab tiles in a sequential grid with VMEM accumulators; a row per
// block keeps the whole reduction inside one block, so nothing crosses blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int CE_THREADS = 256;

struct RowState {
  float m, s;  // running max and sum of exp(x - m)
  float bv;    // best value
  int bi;      // its (lowest) index
  float t;     // target logit
};

__device__ __forceinline__ void consume(RowState& st, float x, int c, int tgt) {
  if (x > st.m) {
    st.s = st.s * expf(st.m - x) + 1.0f;
    st.m = x;
  } else {
    st.s += expf(x - st.m);
  }
  if (x > st.bv || (x == st.bv && c < st.bi)) {
    st.bv = x;
    st.bi = c;
  }
  if (c == tgt) st.t = x;
}

__device__ __forceinline__ void merge(RowState& a, const RowState& b) {
  const float m = fmaxf(a.m, b.m);
  if (m == -INFINITY) {
    a.s = 0.0f;
  } else {
    a.s = a.s * expf(a.m - m) + b.s * expf(b.m - m);
  }
  a.m = m;
  if (b.bv > a.bv || (b.bv == a.bv && b.bi < a.bi)) {
    a.bv = b.bv;
    a.bi = b.bi;
  }
  a.t += b.t;
}

__device__ __forceinline__ RowState shfl(const RowState& st, int o) {
  RowState r;
  r.m = __shfl_xor_sync(0xffffffffu, st.m, o);
  r.s = __shfl_xor_sync(0xffffffffu, st.s, o);
  r.bv = __shfl_xor_sync(0xffffffffu, st.bv, o);
  r.bi = __shfl_xor_sync(0xffffffffu, st.bi, o);
  r.t = __shfl_xor_sync(0xffffffffu, st.t, o);
  return r;
}

__global__ void __launch_bounds__(CE_THREADS)
ce_fwd_ids_kernel(const bf16* __restrict__ logits, int vocab, const int* __restrict__ targets,
                  float* __restrict__ nll, int* __restrict__ ids) {
  __shared__ RowState part[CE_THREADS / 32];
  const int row = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* x = logits + (size_t)row * vocab;
  const int tgt = targets[row];
  RowState st{-INFINITY, 0.0f, -INFINITY, 0x7fffffff, 0.0f};
  if ((vocab & 1) == 0) {  // rows start on 4-byte boundaries: read bf16 pairs
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(x);
    for (int p = tid; p < vocab / 2; p += CE_THREADS) {
      const float2 v = __bfloat1622float2(x2[p]);
      consume(st, v.x, 2 * p, tgt);
      consume(st, v.y, 2 * p + 1, tgt);
    }
  } else {
    for (int c = tid; c < vocab; c += CE_THREADS) consume(st, __bfloat162float(x[c]), c, tgt);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) merge(st, shfl(st, o));
  if (lane == 0) part[warp] = st;
  __syncthreads();
  if (tid == 0) {
    RowState a = part[0];
    for (int w = 1; w < CE_THREADS / 32; ++w) merge(a, part[w]);
    nll[row] = (a.m + logf(a.s)) - a.t;
    ids[row] = a.bi;
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
  if ((vocab & 1) == 0) {
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
  ce_fwd_ids_kernel<<<rows, CE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(logits), vocab, targets, static_cast<float*>(nll),
      static_cast<int*>(ids));
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
