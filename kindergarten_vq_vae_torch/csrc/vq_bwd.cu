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
//   memory (a lane owns its columns: no conflicts, no atomics); it reads the
//   codes of 32 of its rows at once (a lane each), keeps those in the
//   block's code chunk (a ballot) and takes them in order, four rows' z and
//   codebook chunks loaded before their terms are added, so several 16-byte
//   loads of z are in flight a lane;
// - the block adds its warps' slabs in warp order into one partial, and
//   colparts_reduce (layernorm.cu) adds the partials in a fixed order over
//   the card, as the forward's per-code sums are added (vq_fwd.cu). The rows
//   a block takes follow from rows, D and n_e alone, so the bits do too:
//   two launches give the same bits;
// - the partials are at most 128 (one wave of blocks) and as many as
//   CB_SCRATCH_FLOATS holds partials of n_e x D, at least one: a large
//   codebook takes fewer, longer row blocks (10 at 512 x 768, 3 at 1,024 x
//   1,280), so the scratch stays near 16 MiB, or one partial where that is
//   larger, at any n_e x D;
// - g is read on the device (no host sync in the step);
// - an index outside [0, n_e) adds nothing (the forward writes none);
// - a codebook whose slabs do not fit in shared memory beside the chunk's
//   columns (above ~450 codes on the 16-byte path) is cut into chunks of
//   ~112 codes, a third grid dimension: a block adds only the rows whose
//   code lies in its chunk, in the same order, and loads only their z. Any
//   D is cut into column chunks as before.
// The same kernel, with SUMZ, forms the VQ forward's per-code statistics on
// vq_fwd.cu's general path (codebooks or widths its one-pass kernel does not
// hold): per-code sums of z, counts and the sum of the rows' (z_q - z)^2, in
// a fixed order (kvq::vq_sums).

#include <cuda_runtime.h>

#include <cstdint>

#include "layernorm.cuh"

namespace {

constexpr int CB_WARPS = 4;             // warps a block (each a slab)
constexpr int CB_UNROLL = 4;            // rows a warp loads before adding them
constexpr int CB_TARGET_ROW_BLOCKS = 128;
constexpr int CB_SCRATCH_FLOATS = 1 << 22;  // 16 MiB of partials, unless one is larger
constexpr int CB_SMEM_MAX = 232448;     // dynamic shared memory a Hopper block may use

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

struct Plan {
  int warps, rows_per_block, row_blocks, col_blocks, code_blocks, cw, kc;
};

// Bytes of shared memory: warps slabs of kc codes x cw columns, then kc int
// counts.
size_t smem_bytes(int warps, int kc, int cw) {
  return ((size_t)warps * cw + 1) * kc * sizeof(float);
}

// The rows a block takes follow from the shape alone (a multiple of
// CB_WARPS * CB_UNROLL), so the partials do not depend on the path: as many
// row blocks as CB_SCRATCH_FLOATS holds partials of n_e x d, within [1, 128].
void row_plan(int m, int d, int n_e, Plan* p) {
  const int step = CB_WARPS * CB_UNROLL;
  const long long fit = CB_SCRATCH_FLOATS / ((long long)n_e * d);
  const int target = fit < 1 ? 1 : fit < CB_TARGET_ROW_BLOCKS ? (int)fit : CB_TARGET_ROW_BLOCKS;
  const int per = (m + target - 1) / target;
  p->rows_per_block = (per + step - 1) / step * step;
  p->row_blocks = (m + p->rows_per_block - 1) / p->rows_per_block;
}

// 0 when the shape is refused (no rows, no columns or no codes)
int make_plan(int m, int d, int n_e, bool vec, Plan* p) {
  if (m <= 0 || d <= 0 || n_e <= 0) return 0;
  const int chunk = vec ? 128 : 32;  // columns a block
  p->cw = d < chunk ? d : chunk;
  p->warps = 0;
  for (int w = CB_WARPS; w >= 1; w /= 2)
    if (smem_bytes(w, n_e, p->cw) <= (size_t)CB_SMEM_MAX) {
      p->warps = w;
      p->kc = n_e;
      break;
    }
  if (p->warps == 0) {  // code chunks
    p->warps = CB_WARPS;
    p->kc = static_cast<int>(CB_SMEM_MAX / smem_bytes(CB_WARPS, 1, p->cw));
  }
  p->code_blocks = (n_e + p->kc - 1) / p->kc;
  row_plan(m, d, n_e, p);
  p->col_blocks = (d + chunk - 1) / chunk;
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

// Block (cb, rb, kb): columns [cb * 32V, +cw) of the rows [rb *
// rows_per_block, +rows_per_block) whose code lies in [kb * kc, +kc); writes
// its part of the partial parts[rb] (n_e, d). The term of a row is (2 g) *
// (E[k] - z) or, with SUMZ, z; with SUMZ the blocks of the first column
// chunk also write their codes' counts, and block (0, rb, 0) the sum of
// rowdiff over its rows (a lane's rows in order, then the butterfly) and the
// partial's zero pad.
template <bool VEC, bool SUMZ>
__global__ void __launch_bounds__(32 * CB_WARPS)
vq_codebook_grad_kernel(const float* __restrict__ z, const int64_t* __restrict__ idx,
                        const float* __restrict__ codebook, const float* __restrict__ g,
                        const float* __restrict__ rowdiff, float* __restrict__ parts, int m,
                        int d, int n_e, int rows_per_block, int cw, int kc, int part_width) {
  typedef Cols<VEC> C;
  constexpr int V = C::V;
  extern __shared__ __align__(16) float slabs[];  // [warps][kc][cw], then kc counts
  const int W = blockDim.x / 32, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * 32 * V;          // the block's first column
  const int k0 = blockIdx.z * kc;              // the block's first code
  const int nk = min(kc, n_e - k0);
  const int lc = lane * V;                     // the lane's first column in the chunk
  const bool in = lc < cw && c0 + lc < d;      // the chunk's last block may be narrower
  const int slab_floats = nk * cw;
  int* cnt = reinterpret_cast<int*>(slabs + W * kc * cw);
  for (int i = tid; i < W * slab_floats; i += blockDim.x) slabs[i] = 0.0f;
  if (SUMZ)
    for (int i = tid; i < nk; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  const float s = SUMZ ? 1.0f : 2.0f * __ldg(g);  // exact: a power of two
  float* slab = slabs + warp * slab_floats + lc;
  const int row0 = blockIdx.y * rows_per_block;
  const int end = min(m, row0 + rows_per_block);
  // the warp's rows row0 + warp + j W, in order: the codes of 32 of them (a
  // lane each), then those in the block's code chunk, CB_UNROLL at a time
  for (int base = row0 + warp; base < end; base += 32 * W) {
    const int rl = base + lane * W;
    const int64_t kk = rl < end ? __ldg(idx + rl) : -1;
    const int kl = kk >= k0 && kk < k0 + nk ? static_cast<int>(kk - k0) : -1;
    if (SUMZ && kl >= 0 && blockIdx.x == 0) atomicAdd(cnt + kl, 1);
    unsigned hit = __ballot_sync(0xffffffffu, kl >= 0);  // the same in every lane
    while (hit) {
      int k[CB_UNROLL], r[CB_UNROLL];
      float zv[CB_UNROLL][V], ev[CB_UNROLL][V];
#pragma unroll
      for (int u = 0; u < CB_UNROLL; ++u) {  // the next row in the chunk, or none
        const int src = hit ? __ffs(hit) - 1 : 0;
        const int ku = __shfl_sync(0xffffffffu, kl, src);
        k[u] = hit ? ku : -1;
        r[u] = base + src * W;
        hit &= hit - 1;
      }
#pragma unroll
      for (int u = 0; u < CB_UNROLL; ++u) {
        if (k[u] >= 0 && in) {
          C::load_stream(z + (size_t)r[u] * d + c0 + lc, zv[u]);
          if (!SUMZ) C::load_ro(codebook + (size_t)(k0 + k[u]) * d + c0 + lc, ev[u]);
        }
      }
      // the rows in order: each term (2 g) * (E[k] - z), rounded as the
      // plain version rounds it (SUMZ: z), then added
#pragma unroll
      for (int u = 0; u < CB_UNROLL; ++u) {
        if (k[u] >= 0 && in) {
          float* at = slab + k[u] * cw;
          float a[V];
          C::load(at, a);
#pragma unroll
          for (int j = 0; j < V; ++j)
            a[j] = __fadd_rn(a[j], SUMZ ? zv[u][j] : __fmul_rn(s, __fsub_rn(ev[u][j], zv[u][j])));
          C::store(at, a);
        }
      }
    }
  }
  __syncthreads();

  // the block's part of the partial: the warps' slabs in warp order
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
    C::store(out + (size_t)(k0 + code) * d + c0 + c, a);
  }
  const int ned = n_e * d, tail = SUMZ ? ned + n_e + 1 : ned;  // the zero pad starts at tail
  if (SUMZ && blockIdx.x == 0)
    for (int i = tid; i < nk; i += blockDim.x) out[ned + k0 + i] = static_cast<float>(cnt[i]);
  if (blockIdx.x == 0 && blockIdx.z == 0) {
    if (SUMZ && warp == 0) {  // a lane's rows in order, then the butterfly
      float df = 0.0f;
      for (int rr = row0 + lane; rr < end; rr += 32) df += rowdiff[rr];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) df += __shfl_xor_sync(0xffffffffu, df, o);
      if (lane == 0) out[ned + n_e] = df;
    }
    if (tid < part_width - tail) out[tail + tid] = 0.0f;
  }
}

template <bool VEC, bool SUMZ>
cudaError_t launch(const Plan& p, cudaStream_t st, const float* z, const int64_t* idx,
                   const float* codebook, const float* g, const float* rowdiff, float* parts,
                   int m, int d, int n_e, int part_width) {
  auto* kernel = vq_codebook_grad_kernel<VEC, SUMZ>;
  static unsigned configured = 0;  // a bit per device whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(configured >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CB_SMEM_MAX);
    if (e != cudaSuccess) return e;
    if (dev < 32) configured |= 1u << dev;
  }
  kernel<<<dim3(p.col_blocks, p.row_blocks, p.code_blocks), 32 * p.warps,
           smem_bytes(p.warps, p.kc, p.cw), st>>>(z, idx, codebook, g, rowdiff, parts, m, d, n_e,
                                                  p.rows_per_block, p.cw, p.kc, part_width);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

bool vec_path(const float* z, const float* codebook, int d) {
  return d % 4 == 0 && aligned16(z) && aligned16(codebook);
}

}  // namespace

namespace kvq {

// The row blocks (partials) of vq_sums for m rows of d columns, n_e codes.
int vq_sums_row_blocks(int m, int d, int n_e) {
  Plan p;
  row_plan(m, d, n_e, &p);
  return p.row_blocks;
}

// The VQ forward's statistics from its rows' codes: out (part_width =
// round4(n_e d + n_e + 1) floats) = sum_z (n_e, d) | counts (n_e) | the sum
// of rowdiff (m) | 0 pad, each summed in a fixed order. parts:
// vq_sums_row_blocks(m) * part_width floats of scratch, 16-byte aligned.
cudaError_t vq_sums(const float* z, const int64_t* idx, const float* rowdiff, float* parts,
                    float* out, int m, int d, int n_e, cudaStream_t st) {
  Plan p;
  const bool vec = d % 4 == 0 && aligned16(z);
  if (!make_plan(m, d, n_e, vec, &p)) return cudaErrorInvalidValue;
  const int width = round4(n_e * d + n_e + 1);
  const cudaError_t e =
      vec ? launch<true, true>(p, st, z, idx, nullptr, nullptr, rowdiff, parts, m, d, n_e, width)
          : launch<false, true>(p, st, z, idx, nullptr, nullptr, rowdiff, parts, m, d, n_e, width);
  if (e != cudaSuccess) return e;
  return colparts_reduce(parts, p.row_blocks, width, out, st);
}

}  // namespace kvq

extern "C" {

// plan (2 ints): row blocks (partials), the width of a partial and of out
// (floats). Returns 0, or cudaErrorInvalidValue for a shape the kernel does
// not take.
int kvq_vq_codebook_grad_plan(int m, int d, int n_e, const void* z, const void* codebook,
                              int* plan) {
  Plan p;
  const bool vec = vec_path(static_cast<const float*>(z), static_cast<const float*>(codebook), d);
  if (!make_plan(m, d, n_e, vec, &p)) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.row_blocks, plan[1] = round4(n_e * d);
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
  const int width = round4(n_e * d);
  const cudaError_t e =
      vec ? launch<true, false>(p, st, z, idx, codebook, g, nullptr, ws, m, d, n_e, width)
          : launch<false, false>(p, st, z, idx, codebook, g, nullptr, ws, m, d, n_e, width);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(kvq::colparts_reduce(ws, p.row_blocks, width, out, st));
}

}  // extern "C"
