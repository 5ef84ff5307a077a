// Single-pass AMSGrad update (L2 decay, both moments, bias corrections, the
// AMSGrad max, the step) over every trainable f32 leaf, for Hopper (sm_90a).
//
// Replaces kindergarten_vq_vae_tpu/ops/adam_pallas.py `_adam_kernel` (l.46,
// pallas_call at l.76). Per element, in this order (l.51-62 and the plain
// version `_leaf_update_jnp`, l.92-99):
//
//   g'   = g + wd * p
//   mu   = omb1 * g' + b1 * mu
//   nu   = omb2 * (g' * g') + b2 * nu
//   vmax = max(vmax, nu / bc2)
//   p    = p - lr * ((mu / bc1) / (sqrt(vmax) + eps))
//
// Every operation is written with its round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), which nvcc never contracts
// into an fma, so the kernel rounds where the plain PyTorch version
// (ops/adam.py `adam_update_reference`, one elementwise kernel per
// operation) rounds, and the two agree bit for bit. The scalars are computed
// on the host in f32 and passed by value; the kernel never reads the step
// count. The update is in place (p, mu, nu and vmax are overwritten), as
// the port's optimizer state is updated in place.
//
// What bounds it on the H100: bytes. Each element reads p, g, mu, nu and
// vmax and writes p, mu, nu and vmax, all f32: 36 B (32 B where the leaf
// has no gradient), so ~248M trainable elements of the bert-base
// Shelgon3-VQ move ~8.9 GB, ~2.7 ms at 3.35 TB/s. The arithmetic (two
// divisions and a square root per element) is far below the compute rate.
//
// Design. The TPU ran one pallas_call per 2-D lane-aligned leaf (a VMEM
// tiling rule) and left 1-D leaves to XLA. Here one launch covers every
// trainable leaf: the wrapper passes a device table of leaves (pointers and
// sizes) and a table of (leaf, first element) chunks of ADAM_CHUNK elements;
// one block walks one chunk with 16-byte loads per thread when all five
// pointers of the leaf are 16-byte aligned, and finishes the ragged end of
// the chunk (a leaf of odd length, such as the (30522,) MLM bias) with
// scalar loads, never reading past the leaf. A null gradient pointer means
// a gradient of zero (a leaf the loss does not reach, such as the encoder's
// pooler): the leaf is still updated, as optax updates it, and its moments
// decay. Frozen leaves are not in the table.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ADAM_THREADS = 256;
constexpr long long ADAM_CHUNK = 65536;  // elements per block

struct Leaf {  // one row of the (n_leaves, 6) int64 table the wrapper builds
  float* p;
  const float* g;  // null: the gradient is zero
  float* mu;
  float* nu;
  float* vm;
  long long n;
};

struct Scalars {
  float lr, wd, b1, b2, eps, bc1, bc2, omb1, omb2;
};

__device__ __forceinline__ void update(float& p, float g, float& mu, float& nu, float& vm,
                                       const Scalars& s) {
  const float gg = __fadd_rn(g, __fmul_rn(s.wd, p));
  mu = __fadd_rn(__fmul_rn(s.omb1, gg), __fmul_rn(s.b1, mu));
  nu = __fadd_rn(__fmul_rn(s.omb2, __fmul_rn(gg, gg)), __fmul_rn(s.b2, nu));
  const float q = __fdiv_rn(nu, s.bc2);
  vm = (q > vm || q != q) ? q : vm;  // torch.maximum: NaN wins
  const float upd = __fdiv_rn(__fdiv_rn(mu, s.bc1), __fadd_rn(__fsqrt_rn(vm), s.eps));
  p = __fsub_rn(p, __fmul_rn(s.lr, upd));
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

__global__ void __launch_bounds__(ADAM_THREADS)
adam_amsgrad_kernel(const Leaf* __restrict__ leaves, const long long* __restrict__ chunks,
                    Scalars s) {
  const long long li = chunks[2 * blockIdx.x], start = chunks[2 * blockIdx.x + 1];
  const Leaf L = leaves[li];
  const long long rest = L.n - start;
  const long long len = rest < ADAM_CHUNK ? rest : ADAM_CHUNK;
  float* p = L.p + start;
  const float* g = L.g ? L.g + start : nullptr;
  float* mu = L.mu + start;
  float* nu = L.nu + start;
  float* vm = L.vm + start;
  const bool vec = aligned16(p) && aligned16(g) && aligned16(mu) && aligned16(nu) &&
                   aligned16(vm);
  const long long nvec = vec ? len / 4 : 0;
  for (long long i = threadIdx.x; i < nvec; i += ADAM_THREADS) {
    float4 pv = reinterpret_cast<float4*>(p)[i];
    const float4 gv = g ? reinterpret_cast<const float4*>(g)[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 mv = reinterpret_cast<float4*>(mu)[i];
    float4 nv = reinterpret_cast<float4*>(nu)[i];
    float4 vv = reinterpret_cast<float4*>(vm)[i];
    update(pv.x, gv.x, mv.x, nv.x, vv.x, s);
    update(pv.y, gv.y, mv.y, nv.y, vv.y, s);
    update(pv.z, gv.z, mv.z, nv.z, vv.z, s);
    update(pv.w, gv.w, mv.w, nv.w, vv.w, s);
    reinterpret_cast<float4*>(p)[i] = pv;
    reinterpret_cast<float4*>(mu)[i] = mv;
    reinterpret_cast<float4*>(nu)[i] = nv;
    reinterpret_cast<float4*>(vm)[i] = vv;
  }
  for (long long i = 4 * nvec + threadIdx.x; i < len; i += ADAM_THREADS) {
    float pv = p[i], mv = mu[i], nv = nu[i], vv = vm[i];
    update(pv, g ? g[i] : 0.0f, mv, nv, vv, s);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = nv;
    vm[i] = vv;
  }
}

}  // namespace

extern "C" {

// Elements per chunk: the wrapper cuts every leaf into chunks of this size.
long long kvq_adam_chunk() { return ADAM_CHUNK; }

// leaves: device (n_leaves, 6) int64 rows {p, g or 0, mu, nu, vmax, numel};
// chunks: device (n_chunks, 2) int64 rows {leaf index, first element}.
int kvq_adam_amsgrad(const void* leaves, const void* chunks, int n_chunks, float lr, float wd,
                     float b1, float b2, float eps, float bc1, float bc2, float omb1, float omb2,
                     void* stream) {
  if (n_chunks <= 0) return 0;
  const Scalars s{lr, wd, b1, b2, eps, bc1, bc2, omb1, omb2};
  adam_amsgrad_kernel<<<n_chunks, ADAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), static_cast<const long long*>(chunks), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
