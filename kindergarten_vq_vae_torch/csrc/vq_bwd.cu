// VQ-VAE bottleneck backward for Hopper (sm_90a): the codebook gradient in a
// fixed order.
//
// Replaces the segment sum of kindergarten_vq_vae_tpu/ops/vq_pallas.py
// `_fused_vq_core_bwd` (l.173-181), which XLA lowers with its own kernel:
//   dE[k, :] = sum over rows i with idx[i] = k of 2 g (E[k, :] - z[i, :])
// in f32, a code that no row picks exactly 0. PyTorch's `index_add_` adds
// these terms with atomics in whatever order the threads land, so on the
// card a step does not repeat its own bits, and the tp ranks of a mesh,
// which update their replicated codebook each on its own, may drift apart.
// Each term is the plain version's: (2 g) * (E[k] - z[i]), each operation
// rounded on its own (no FMA), so only the order of the sum differs. The sum
// runs over the differences, as JAX's does; n_k E_k - sum z from the
// forward's statistics would cancel once z sits near its code.
//
// What bounds it on the H100: bytes. At the training step (24,576 rows x
// 768, f32, 9 codes) it reads 75.5 MB of z and 0.2 MB of idx and writes 28
// KB of dE: 0.023 ms at 3.35 TB/s; the arithmetic (two operations an
// element) is far below. What the design does about it:
// - the grid is (column chunks, row blocks); a block's four warps take the
//   same 128 columns (32 lanes x 16 bytes; 32 single columns on the element
//   path), each warp every fourth row of the block's range, in order;
// - a warp adds its rows' terms into its own slab of per-code sums in shared
//   memory (a lane owns its columns: no conflicts, no atomics); four rows'
//   idx, z and codebook chunks are loaded before their terms are added, so
//   several 16-byte loads of z are in flight a lane;
// - the block adds its warps' slabs in warp order into one partial, and
//   colparts_reduce (layernorm.cu) adds the partials in a fixed order over
//   the card, as the forward's per-code sums are added (vq_fwd.cu). The rows
//   a block takes follow from the row count alone, so the bits depend on
//   rows, D and n_e alone: two launches give the same bits;
// - g is read on the device (no host sync in the step);
// - an index outside [0, n_e) adds nothing (the forward writes none).

#include <cuda_runtime.h>

#include <cstdint>

#include "layernorm.cuh"

namespace {

constexpr int CB_WARPS = 4;             // warps a block (each a slab)
constexpr int CB_UNROLL = 4;            // rows a warp loads before adding them
constexpr int CB_TARGET_ROW_BLOCKS = 128;
constexpr int CB_SMEM_MAX = 232448;     // dynamic shared memory a Hopper block may use
constexpr int CB_MAX_DIM = 1024;        // the forward's limit (vq_fwd.cu)

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

struct Plan {
  int warps, rows_per_block, row_blocks, col_blocks, cw, part_width;
};

// 0 when the shape is refused (D > 1024, or no slab fits in shared memory)
int make_plan(int m, int d, int n_e, bool vec, Plan* p) {
  if (m <= 0 || d <= 0 || d > CB_MAX_DIM || n_e <= 0) return 0;
  const int chunk = vec ? 128 : 32;  // columns a block
  p->cw = d < chunk ? d : chunk;
  p->warps = 0;
  for (int w = CB_WARPS; w >= 1; w /= 2)
    if ((size_t)w * n_e * p->cw * sizeof(float) <= (size_t)CB_SMEM_MAX) {
      p->warps = w;
      break;
    }
  if (p->warps == 0) return 0;
  const int step = p->warps * CB_UNROLL;
  const int per = (m + CB_TARGET_ROW_BLOCKS - 1) / CB_TARGET_ROW_BLOCKS;
  p->rows_per_block = (per + step - 1) / step * step;
  p->row_blocks = (m + p->rows_per_block - 1) / p->rows_per_block;
  p->col_blocks = (d + chunk - 1) / chunk;
  p->part_width = round4(n_e * d);  // dE (n_e, d) | 0 pad
  return 1;
}

template <bool VEC>
struct Cols {
  static constexpr int V = VEC ? 4 : 1;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    if constexpr (VEC) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      v[0] = *p;
    }
  }
  // z: read once, past L1 (which keeps the codebook)
  __device__ __forceinline__ static void load_stream(const float* p, float* v) {
    if constexpr (VEC) {
      asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
          : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
          : "l"(p));
    } else {
      v[0] = __ldcs(p);
    }
  }
  __device__ __forceinline__ static void load_ro(const float* p, float* v) {
    if constexpr (VEC) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      v[0] = __ldg(p);
    }
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    if constexpr (VEC)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *p = v[0];
  }
};

// Block (cb, rb): columns [cb * 32V, +cw) of the rows [rb * rows_per_block,
// +rows_per_block); writes its partial (n_e, d) into parts[rb].
template <bool VEC>
__global__ void __launch_bounds__(32 * CB_WARPS)
vq_codebook_grad_kernel(const float* __restrict__ z, const int64_t* __restrict__ idx,
                        const float* __restrict__ codebook, const float* __restrict__ g,
                        float* __restrict__ parts, int m, int d, int n_e, int rows_per_block,
                        int cw, int part_width) {
  typedef Cols<VEC> C;
  constexpr int V = C::V;
  extern __shared__ __align__(16) float slabs[];  // [warps][n_e][cw]
  const int W = blockDim.x / 32, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * 32 * V;          // the block's first column
  const int lc = lane * V;                     // the lane's first column in the chunk
  const bool in = lc < cw && c0 + lc < d;      // the chunk's last block may be narrower
  const int slab_floats = n_e * cw;
  for (int i = tid; i < W * slab_floats; i += blockDim.x) slabs[i] = 0.0f;
  __syncthreads();

  const float s = 2.0f * __ldg(g);  // exact: a power of two
  float* slab = slabs + warp * slab_floats + lc;
  const int row0 = blockIdx.y * rows_per_block;
  const int end = min(m, row0 + rows_per_block);
  for (int r = row0 + warp; r < end; r += W * CB_UNROLL) {
    int k[CB_UNROLL];
    float zv[CB_UNROLL][V], ev[CB_UNROLL][V];
#pragma unroll
    for (int u = 0; u < CB_UNROLL; ++u) {
      const int rr = r + u * W;
      const int64_t kk = rr < end ? __ldg(idx + rr) : -1;
      k[u] = kk >= 0 && kk < n_e ? static_cast<int>(kk) : -1;
    }
#pragma unroll
    for (int u = 0; u < CB_UNROLL; ++u) {
      if (k[u] >= 0 && in) {
        C::load_stream(z + (size_t)(r + u * W) * d + c0 + lc, zv[u]);
        C::load_ro(codebook + (size_t)k[u] * d + c0 + lc, ev[u]);
      }
    }
    // the rows in order: each term (2 g) * (E[k] - z), rounded as the plain
    // version rounds it, then added
#pragma unroll
    for (int u = 0; u < CB_UNROLL; ++u) {
      if (k[u] >= 0 && in) {
        float* at = slab + k[u] * cw;
        float a[V];
        C::load(at, a);
#pragma unroll
        for (int j = 0; j < V; ++j)
          a[j] = __fadd_rn(a[j], __fmul_rn(s, __fsub_rn(ev[u][j], zv[u][j])));
        C::store(at, a);
      }
    }
  }
  __syncthreads();

  // the block's partial: the warps' slabs in warp order
  float* out = parts + (size_t)blockIdx.y * part_width;
  for (int i = tid * V; i < slab_floats; i += blockDim.x * V) {
    const int code = i / cw, c = i % cw;
    if (c0 + c >= d) continue;
    float a[V], t[V];
    C::load(slabs + i, a);
    for (int w = 1; w < W; ++w) {
      C::load(slabs + w * slab_floats + i, t);
#pragma unroll
      for (int j = 0; j < V; ++j) a[j] += t[j];
    }
    C::store(out + (size_t)code * d + c0 + c, a);
  }
  if (blockIdx.x == 0 && tid < part_width - n_e * d) out[n_e * d + tid] = 0.0f;
}

template <bool VEC>
cudaError_t launch(const Plan& p, cudaStream_t st, const float* z, const int64_t* idx,
                   const float* codebook, const float* g, float* parts, int m, int d, int n_e) {
  auto* kernel = vq_codebook_grad_kernel<VEC>;
  const size_t smem = (size_t)p.warps * n_e * p.cw * sizeof(float);
  static unsigned configured = 0;  // a bit per device whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(configured >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CB_SMEM_MAX);
    if (e != cudaSuccess) return e;
    if (dev < 32) configured |= 1u << dev;
  }
  kernel<<<dim3(p.col_blocks, p.row_blocks), 32 * p.warps, smem, st>>>(
      z, idx, codebook, g, parts, m, d, n_e, p.rows_per_block, p.cw, p.part_width);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

bool vec_path(const float* z, const float* codebook, int d) {
  return d % 4 == 0 && aligned16(z) && aligned16(codebook);
}

}  // namespace

extern "C" {

// plan (2 ints): row blocks (partials), the width of a partial and of out
// (floats). Returns 0, or cudaErrorInvalidValue for a shape the kernel does
// not take.
int kvq_vq_codebook_grad_plan(int m, int d, int n_e, const void* z, const void* codebook,
                              int* plan) {
  Plan p;
  const bool vec = vec_path(static_cast<const float*>(z), static_cast<const float*>(codebook), d);
  if (!make_plan(m, d, n_e, vec, &p)) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.row_blocks, plan[1] = p.part_width;
  return 0;
}

// z (m, d) f32, idx (m,) int64, codebook (n_e, d) f32, g (1,) f32 on the
// device -> out (part_width,) f32: dE (n_e, d) | 0 pad. ws: row_blocks *
// part_width floats of scratch, 16-byte aligned.
int kvq_vq_codebook_grad(const float* z, const int64_t* idx, const float* codebook,
                         const float* g, float* ws, float* out, int m, int d, int n_e,
                         void* stream) {
  Plan p;
  const bool vec = vec_path(z, codebook, d);
  if (!make_plan(m, d, n_e, vec, &p) || !aligned16(ws) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = vec ? launch<true>(p, st, z, idx, codebook, g, ws, m, d, n_e)
                            : launch<false>(p, st, z, idx, codebook, g, ws, m, d, n_e);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(kvq::colparts_reduce(ws, p.row_blocks, p.part_width, out, st));
}

}  // extern "C"
