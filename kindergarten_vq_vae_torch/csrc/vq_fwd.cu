// VQ-VAE bottleneck forward for Hopper (sm_90a).
//
// Replaces kindergarten_vq_vae_tpu/ops/vq_pallas.py `_vq_kernel` (l.41,
// launched by `_vq_forward_pallas` l.95): in one pass over z it computes
// centered distances, the first-minimum argmin, the z_q gather, per-code
// counts, per-code sums of z and the sum of (z_q - z)^2.
//
// What bounds it on the H100: at the serving bucket (3072 rows x 768, f32,
// 9 codes) it reads 9.4 MB of z and writes 9.4 MB of z_q, against ~42 MF of
// distance arithmetic: it is memory- and latency-bound and small. The
// design reads each z row once into registers (one warp per row), keeps
// the codebook (27.6 KB at 9 x 768) in shared memory, and replaces the TPU
// kernel's grid-carried accumulators (the TPU grid runs in order) with
// per-CTA partial sums reduced by a second small kernel in a fixed order:
// deterministic, no float atomics. Distances keep the centered expansion
// ||z-c||^2 + ||e-c||^2 - 2 (z-c).(e-c) of vq_pallas.py:55-64 so ties break
// as the oracle's do; z_q is an exact copy of the chosen code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VQ_THREADS = 256;
constexpr int VQ_WARPS = VQ_THREADS / 32;
constexpr int VQ_ROWS = 32;       // rows per CTA
constexpr int VQ_MAX_PER_LANE = 32;  // d <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory: codebook e[n_e*d], per-code sums sz[n_e*d],
// centre c[d], ||e-c||^2 esq[n_e], per-row diff rdiff[VQ_ROWS], per-row code ridx[VQ_ROWS].
__global__ void __launch_bounds__(VQ_THREADS)
vq_assign_kernel(const float* __restrict__ z, const float* __restrict__ codebook,
                 float* __restrict__ zq, int64_t* __restrict__ idx,
                 float* __restrict__ part_counts, float* __restrict__ part_sumz,
                 float* __restrict__ part_diff, int m, int d, int n_e) {
  extern __shared__ float smem[];
  float* es = smem;
  float* sz = es + n_e * d;
  float* cs = sz + n_e * d;
  float* esq = cs + d;
  float* rdiff = esq + n_e;
  int* ridx = reinterpret_cast<int*>(rdiff + VQ_ROWS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int blk = blockIdx.x, row0 = blk * VQ_ROWS;

  for (int i = tid; i < n_e * d; i += VQ_THREADS) {
    es[i] = codebook[i];
    sz[i] = 0.0f;
  }
  __syncthreads();
  // centre over the n_e real codes, summed in code order
  for (int c = tid; c < d; c += VQ_THREADS) {
    float s = 0.0f;
    for (int k = 0; k < n_e; ++k) s += es[k * d + c];
    cs[c] = s / n_e;
  }
  __syncthreads();
  for (int k = warp; k < n_e; k += VQ_WARPS) {
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float t = es[k * d + c] - cs[c];
      s += t * t;
    }
    s = warp_sum(s);
    if (lane == 0) esq[k] = s;
  }
  __syncthreads();

  for (int r = warp; r < VQ_ROWS; r += VQ_WARPS) {
    const int row = row0 + r;
    if (row >= m) {
      if (lane == 0) {
        ridx[r] = -1;
        rdiff[r] = 0.0f;
      }
      continue;
    }
    const float* zr = z + (size_t)row * d;
    float zc[VQ_MAX_PER_LANE];
    float zsq = 0.0f;
#pragma unroll
    for (int t = 0; t < VQ_MAX_PER_LANE; ++t) {
      const int c = lane + 32 * t;
      zc[t] = c < d ? zr[c] - cs[c] : 0.0f;
      zsq += zc[t] * zc[t];
    }
    zsq = warp_sum(zsq);  // butterfly: every lane holds the same bits
    float best = 0.0f;
    int bi = 0;
    for (int k = 0; k < n_e; ++k) {
      float cr = 0.0f;
#pragma unroll
      for (int t = 0; t < VQ_MAX_PER_LANE; ++t) {
        const int c = lane + 32 * t;
        if (c < d) cr += zc[t] * (es[k * d + c] - cs[c]);
      }
      cr = warp_sum(cr);
      const float dist = zsq + esq[k] - 2.0f * cr;
      if (k == 0 || dist < best) {  // strict: the first minimum wins
        best = dist;
        bi = k;
      }
    }
    const float* er = es + bi * d;
    float* zqr = zq + (size_t)row * d;
    float ds = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float q = er[c];
      zqr[c] = q;
      const float df = q - zr[c];
      ds += df * df;
    }
    ds = warp_sum(ds);
    if (lane == 0) {
      ridx[r] = bi;
      rdiff[r] = ds;
      idx[row] = bi;
    }
  }
  __syncthreads();

  // per-CTA partials, each summed in row order by the thread that owns it
  for (int r = 0; r < VQ_ROWS; ++r) {
    const int k = ridx[r];
    if (k < 0) continue;
    const float* zr = z + (size_t)(row0 + r) * d;
    for (int c = tid; c < d; c += VQ_THREADS) sz[k * d + c] += zr[c];
  }
  for (int k = tid; k < n_e; k += VQ_THREADS) {
    float cnt = 0.0f;
    for (int r = 0; r < VQ_ROWS; ++r) cnt += ridx[r] == k ? 1.0f : 0.0f;
    part_counts[(size_t)blk * n_e + k] = cnt;
  }
  if (tid == 0) {
    float s = 0.0f;
    for (int r = 0; r < VQ_ROWS; ++r) s += rdiff[r];
    part_diff[blk] = s;
  }
  __syncthreads();
  for (int i = tid; i < n_e * d; i += VQ_THREADS) part_sumz[(size_t)blk * n_e * d + i] = sz[i];
}

// Sums the per-CTA partials in CTA order.
__global__ void vq_reduce_kernel(const float* __restrict__ part_counts,
                                 const float* __restrict__ part_sumz,
                                 const float* __restrict__ part_diff, float* __restrict__ counts,
                                 float* __restrict__ sumz, float* __restrict__ diff, int nblk,
                                 int d, int n_e) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < n_e * d) {
    float s = 0.0f;
    for (int b = 0; b < nblk; ++b) s += part_sumz[(size_t)b * n_e * d + j];
    sumz[j] = s;
  }
  if (j < n_e) {
    float s = 0.0f;
    for (int b = 0; b < nblk; ++b) s += part_counts[(size_t)b * n_e + j];
    counts[j] = s;
  }
  if (j == 0) {
    float s = 0.0f;
    for (int b = 0; b < nblk; ++b) s += part_diff[b];
    *diff = s;
  }
}

}  // namespace

extern "C" {

int kvq_vq_rows_per_block() { return VQ_ROWS; }

size_t kvq_vq_smem_bytes(int d, int n_e) {
  return sizeof(float) * (2 * (size_t)n_e * d + d + n_e + VQ_ROWS) + sizeof(int) * VQ_ROWS;
}

// z (m, d) f32, codebook (n_e, d) f32 -> zq (m, d) f32, idx (m,) int64,
// counts (n_e,), sumz (n_e, d), diff (1,). part_* are scratch of
// ceil(m / kvq_vq_rows_per_block()) CTAs.
int kvq_vq_fwd(const float* z, const float* codebook, float* zq, int64_t* idx,
               float* part_counts, float* part_sumz, float* part_diff, float* counts, float* sumz,
               float* diff, int m, int d, int n_e, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (m + VQ_ROWS - 1) / VQ_ROWS;
  const size_t smem = kvq_vq_smem_bytes(d, n_e);
  cudaError_t err = cudaFuncSetAttribute(vq_assign_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  vq_assign_kernel<<<nblk, VQ_THREADS, smem, st>>>(z, codebook, zq, idx, part_counts, part_sumz,
                                                    part_diff, m, d, n_e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = n_e * d, threads = 256;
  vq_reduce_kernel<<<(total + threads - 1) / threads, threads, 0, st>>>(
      part_counts, part_sumz, part_diff, counts, sumz, diff, nblk, d, n_e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
