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
// The order of the sum (both kernels below keep it to the bit): the rows
// are cut into row blocks of rpb rows (row_plan: as many, at most 128, as
// 2^22 floats hold partials of n_e x D); in a row block, slot w (w < W)
// adds the rows row0 + w + j W of its code in order, from 0; a block's
// partial is slot 0 + slot 1 + ... in slot order; strip s (s < 8) adds the
// partials of row blocks s, s + 8, ... in order, from 0; the sum is strip 0
// + strip 1 + ... + strip 7. W is 4, or 2 or 1 where the one-pass kernel's
// per-warp slabs fit only so many to a block (below). The order depends on
// the shape alone: two launches give the same bits.
//
// What bounds it on the H100: bytes. At the training step (24,576 rows x
// 768, f32) it reads 75.5 MB of z and 0.2 MB of idx and writes n_e x 768
// floats of dE: 0.023 ms at 3.35 TB/s at 9 codes, 0.024 at 512; the
// arithmetic (two operations an element) is far below.
//
// The one-pass kernel (vq_codebook_grad_kernel; the step's 9 codes, any
// codebook whose four slabs fit in shared memory: up to ~113 codes on the
// 16-byte path): the grid is (column chunks, row blocks); a block's W
// warps take the same 128 columns (32 lanes x 16 bytes; 32 single columns
// on the element path), warp w the rows of slot w, and add their terms into
// its own slab of per-code sums in shared memory (a lane owns its columns:
// no conflicts, no atomics), reading the codes of 32 of its rows at once (a
// lane each) and four rows' z and codebook chunks before their terms are
// added; the block adds its slabs in slot order into one partial, and
// colparts_reduce (layernorm.cu), whose strips are the order's, sums the
// partials over the card.
//
// The grouped sums (every larger codebook; and, with the term z, the VQ
// forward's per-code statistics on vq_fwd.cu's general path): a slab a warp
// costs more shared memory than the z it sums once the codebook is large
// (at 512 codes one block of 4 warps an SM, 231 KB of slabs zeroed and
// reduced a block, idx read once per column and code chunk), so the rows
// are grouped by code first, and each code's sums are taken from its own
// rows:
// - a stable counting sort of the row ids by code: per-unit histograms (a
//   unit at most 1,024 rows of one row block), a prefix in code, then unit,
//   order (one block), and a scatter (a row a thread: its rank among the
//   warp's rows of its code by __match_any_sync, plus the rows of its code
//   in the unit's warps before it, from a byte table of the warps' counts),
//   so each code's rows come out ascending and each (code, row block) range
//   is known;
// - a code of at most VQG_LONG rows is one warp's per 128-column chunk: E[k]'s
//   chunk in registers, its rows in order with 16-byte loads of z, 8 at a
//   time (their ids a group ahead), into W slots; at each row
//   block's end the slots fold into that block's strip (in shared memory,
//   the lane's own columns); the sum is written once: no slabs, no
//   partials;
// - a longer code is cut at its row blocks and slots, the order's
//   independent chains: a warp a (code, column chunk, row block, slot)
//   piece, every piece at once, its rows prefetched into L2 and taken 16 at
//   a time, their sum a partial of the piece; a fold adds each code's
//   partials in the order. At initialisation a bert-base encoder's rows
//   share a direction and a codebook uniform in +-1/n_e collapses onto a
//   few codes, so this path carries the step;
// - a persistent grid's warps take the codes from a counter, the most rows
//   first (the longest codes set the time: at 512 random codes 48 rows on
//   average, 82 at most); where a code's sum is taken changes no bit of it;
// - a VQ forward hands its grouping to the backward (the same rows and
//   codes), which then runs the sums alone;
// - g is read on the device (no host sync in the step); an index outside
//   [0, n_e) adds nothing (the forward writes none).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "layernorm.cuh"
#include "vq_group.cuh"

namespace {

constexpr int CB_WARPS = 4;             // warps a block (each a slab)
constexpr int CB_UNROLL = 4;            // rows a warp loads before adding them
constexpr int CB_TARGET_ROW_BLOCKS = 128;
constexpr int CB_SCRATCH_FLOATS = 1 << 22;  // 16 MiB of partials, unless one is larger
constexpr int CB_SMEM_MAX = 232448;     // dynamic shared memory a Hopper block may use
constexpr unsigned FULL = 0xffffffffu;

constexpr int VQG_LONG = 160;          // a code of more rows takes a block, not a warp
constexpr int VQG_WARPS = 8;           // warps a block of the grouped sums
constexpr int VQG_GROUP = 8;           // rows a warp loads at once (a short code)
constexpr int VQG_LONG_GROUP = 16;     // rows a warp loads at once (a long code's row block)
constexpr int VQG_SMEM_CODES = 32768;  // the scatter's cursors in shared memory up to this many
constexpr int VQG_TABLE_CODES = 3072;  // its per-warp counts (32 x n_e bytes) up to this many
constexpr int SCAN_THREADS = 1024;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

struct Plan {
  int warps, rows_per_block, row_blocks, col_blocks, cw;
};

// Bytes of shared memory: warps slabs of kc codes x cw columns, then kc int
// counts.
size_t smem_bytes(int warps, int kc, int cw) {
  return ((size_t)warps * cw + 1) * kc * sizeof(float);
}

int chunk_cols(int d, bool vec) {
  const int chunk = vec ? 128 : 32;  // columns a block
  return d < chunk ? d : chunk;
}

// The slots of the order: the warps whose slabs of the whole codebook fit a
// block of the one-pass kernel (4, 2 or 1), and 4 where not even one does
// (the code chunks of the kernel before the grouped sums).
int order_warps(int d, int n_e, bool vec) {
  for (int w = CB_WARPS; w >= 1; w /= 2)
    if (smem_bytes(w, n_e, chunk_cols(d, vec)) <= (size_t)CB_SMEM_MAX) return w;
  return CB_WARPS;
}

// The rows a block takes follow from the shape alone (a multiple of
// CB_WARPS * CB_UNROLL): as many row blocks as CB_SCRATCH_FLOATS holds
// partials of n_e x d, within [1, 128].
void row_plan(int m, int d, int n_e, Plan* p) {
  const int step = CB_WARPS * CB_UNROLL;
  const long long fit = CB_SCRATCH_FLOATS / ((long long)n_e * d);
  const int target = fit < 1 ? 1 : fit < CB_TARGET_ROW_BLOCKS ? (int)fit : CB_TARGET_ROW_BLOCKS;
  const int per = (m + target - 1) / target;
  p->rows_per_block = (per + step - 1) / step * step;
  p->row_blocks = (m + p->rows_per_block - 1) / p->rows_per_block;
}

// The one-pass kernel's plan; 0 when the shape is refused (no rows, no
// columns or no codes).
int make_plan(int m, int d, int n_e, bool vec, Plan* p) {
  if (m <= 0 || d <= 0 || n_e <= 0) return 0;
  p->cw = chunk_cols(d, vec);
  p->warps = order_warps(d, n_e, vec);
  row_plan(m, d, n_e, p);
  p->col_blocks = (d + (vec ? 128 : 32) - 1) / (vec ? 128 : 32);
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

// ------------------------------------------------ the one-pass kernel

// Block (cb, rb): columns [cb * 32V, +cw) of the rows [rb * rows_per_block,
// +rows_per_block); writes its part of the partial parts[rb] (n_e, d): the
// sum of each code's terms (2 g) * (E[k] - z).
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
  // the warp's rows row0 + warp + j W, in order: the codes of 32 of them (a
  // lane each), then those rows CB_UNROLL at a time
  for (int base = row0 + warp; base < end; base += 32 * W) {
    const int rl = base + lane * W;
    const int64_t kk = rl < end ? __ldg(idx + rl) : -1;
    const int kl = kk >= 0 && kk < n_e ? static_cast<int>(kk) : -1;
    unsigned hit = __ballot_sync(FULL, kl >= 0);  // the same in every lane
    while (hit) {
      int k[CB_UNROLL], r[CB_UNROLL];
      float zv[CB_UNROLL][V], ev[CB_UNROLL][V];
#pragma unroll
      for (int u = 0; u < CB_UNROLL; ++u) {  // the next row with a code, or none
        const int src = hit ? __ffs(hit) - 1 : 0;
        const int ku = __shfl_sync(FULL, kl, src);
        k[u] = hit ? ku : -1;
        r[u] = base + src * W;
        hit &= hit - 1;
      }
#pragma unroll
      for (int u = 0; u < CB_UNROLL; ++u) {
        if (k[u] >= 0 && in) {
          C::load_stream(z + (size_t)r[u] * d + c0 + lc, zv[u]);
          C::load_ro(codebook + (size_t)k[u] * d + c0 + lc, ev[u]);
        }
      }
      // the rows in order: each term (2 g) * (E[k] - z), rounded as the
      // plain version rounds it, then added
#pragma unroll
      for (int u = 0; u < CB_UNROLL; ++u) {
        if (k[u] >= 0 && in) {
          float* at = slab + k[u] * cw;
          float a[V];
          C::load(at, a);
#pragma unroll
          for (int j = 0; j < V; ++j) a[j] = __fadd_rn(a[j], __fmul_rn(s, __fsub_rn(ev[u][j], zv[u][j])));
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
    C::store(out + (size_t)code * d + c0 + c, a);
  }
  const int ned = n_e * d;  // the zero pad starts there
  if (blockIdx.x == 0 && tid < part_width - ned) out[ned + tid] = 0.0f;
}

template <bool VEC>
cudaError_t launch(const Plan& p, cudaStream_t st, const float* z, const int64_t* idx,
                   const float* codebook, const float* g, float* parts, int m, int d, int n_e,
                   int part_width) {
  auto* kernel = vq_codebook_grad_kernel<VEC>;
  static unsigned configured = 0;  // a bit per device whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(configured >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CB_SMEM_MAX);
    if (e != cudaSuccess) return e;
    if (dev < 32) configured |= 1u << dev;
  }
  kernel<<<dim3(p.col_blocks, p.row_blocks), 32 * p.warps, smem_bytes(p.warps, n_e, p.cw), st>>>(
      z, idx, codebook, g, parts, m, d, n_e, p.rows_per_block, p.cw, part_width);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

bool vec_path(const float* z, const float* codebook, int d) {
  return d % 4 == 0 && aligned16(z) && aligned16(codebook);
}

// ------------------------------------------------ the grouped sums

using kvq::VqGroup;
using kvq::VQG_UNIT_ROWS;

__device__ __forceinline__ void unit_rows(const VqGroup& G, int u, int& r0, int& r1) {
  const int b = u / G.upb, j = u % G.upb;
  r0 = b * G.rpb + j * VQG_UNIT_ROWS;
  r1 = min(min(r0 + VQG_UNIT_ROWS, (b + 1) * G.rpb), G.m);
}

// hist[u][k] += the rows of unit u with code k; a block a unit, a row a thread
__global__ void __launch_bounds__(VQG_UNIT_ROWS)
vq_group_count_kernel(const VqGroup G, const int64_t* __restrict__ idx, int* __restrict__ ws) {
  int r0, r1;
  unit_rows(G, blockIdx.x, r0, r1);
  const int row = r0 + threadIdx.x;
  if (row >= r1) return;
  const int64_t k = idx[row];
  if (k >= 0 && k < G.n_e) atomicAdd(ws + G.hist + (size_t)blockIdx.x * G.n_e + k, 1);
}

// An exclusive scan of v over the block's threads (blockDim a multiple of
// 32), and the totals; sh: 3 x 33 ints.
__device__ __forceinline__ void block_scan3(int (&v)[3], int (&tot)[3], int* sh) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  int inc[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    inc[q] = v[q];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, inc[q], o);
      if (lane >= o) inc[q] += t;
    }
    if (lane == 31) sh[q * 33 + warp] = inc[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int w = lane < warps ? sh[q * 33 + lane] : 0;
      int x = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += t;
      }
      sh[q * 33 + lane] = x - w;
      if (lane == 31) sh[q * 33 + 32] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    v[q] = sh[q * 33 + warp] + inc[q] - v[q];
    tot[q] = sh[q * 33 + 32];
  }
  __syncthreads();  // sh is read again by the next scan
}

// One block: each code's rows (its units' counts), in code order its first
// sorted row; hist's counts become each (unit, code)'s first sorted row;
// the short and long codes' lists, a long code's first row in each row
// block. With sumz also the counts and the sum of rowdiff into out, in the
// one-pass kernel's order (a row block's lanes in order, the butterfly,
// then colparts_reduce's strips); out's pad from tail to out_width is 0.
__global__ void __launch_bounds__(SCAN_THREADS)
vq_group_scan_kernel(const VqGroup G, int* __restrict__ ws, float* __restrict__ out,
                     int out_width, const float* __restrict__ rowdiff, int sumz) {
  __shared__ int sh[3 * 33];
  __shared__ float dsum[CB_TARGET_ROW_BLOCKS];
  int* hist = ws + G.hist;
  int4* shorts = reinterpret_cast<int4*>(ws + G.shorts);
  int* longs = ws + G.longs;
  int* lpos = ws + G.lpos;
  const int tid = threadIdx.x, n_e = G.n_e;
  int carry[3] = {0, 0, 0};  // rows, short codes, long codes before this round
  for (int base = 0; base < n_e; base += blockDim.x) {
    const int k = base + tid;
    int total = 0;
    int c32[32];  // up to 32 units' counts, kept for the second pass
    const bool few = G.units <= 32;
    if (k < n_e && few) {
#pragma unroll
      for (int j = 0; j < 32; ++j) c32[j] = j < G.units ? hist[(size_t)j * n_e + k] : 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) total += c32[j];
    } else if (k < n_e) {
      for (int u0 = 0; u0 < G.units; u0 += 8) {  // 8 loads in flight
        int c[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) c[j] = u0 + j < G.units ? hist[(size_t)(u0 + j) * n_e + k] : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) total += c[j];
      }
    }
    const bool lng = k < n_e && total > VQG_LONG;
    int v[3] = {total, k < n_e && !lng ? 1 : 0, lng ? 1 : 0}, tot[3];
    block_scan3(v, tot, sh);
    if (k < n_e) {
      const int first = carry[0] + v[0];
      const int lr = carry[2] + v[2];
      int* lp = lpos + (size_t)lr * (G.n_rb + 1);
      int running = first;
      if (few) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if (j < G.units) {
            if (lng && j % G.upb == 0) lp[j / G.upb] = running;  // a row block's first unit
            hist[(size_t)j * n_e + k] = running;
            running += c32[j];
          }
        }
      }
      for (int u0 = 0; !few && u0 < G.units; u0 += 8) {  // 8 loads in flight, then their stores
        int c[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) c[j] = u0 + j < G.units ? hist[(size_t)(u0 + j) * n_e + k] : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int u = u0 + j;
          if (u >= G.units) break;
          if (lng && u % G.upb == 0) lp[u / G.upb] = running;  // a row block's first unit
          hist[(size_t)u * n_e + k] = running;
          running += c[j];
        }
      }
      if (lng) {
        lp[G.n_rb] = running;
        longs[lr] = k;
      } else {
        shorts[carry[1] + v[1]] = make_int4(k, first, running, 0);
      }
      if (sumz) out[(size_t)n_e * G.d + k] = static_cast<float>(total);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) carry[q] += tot[q];
  }
  if (tid == 0) {
    ws[G.meta] = carry[1];
    ws[G.meta + 1] = carry[2];
    ws[G.meta + 2] = 0;  // the sums' work counter
  }
  // the short codes again, the most rows first (each code's sum does not
  // depend on where or when it is taken: only which warp waits longest)
  __shared__ int bins[VQG_LONG + 1];
  for (int i = tid; i <= VQG_LONG; i += blockDim.x) bins[i] = 0;
  __syncthreads();
  int4* order = reinterpret_cast<int4*>(ws + G.order);
  for (int i = tid; i < carry[1]; i += blockDim.x) atomicAdd(bins + shorts[i].z - shorts[i].y, 1);
  __syncthreads();
  if (tid == 0)
    for (int sz = VQG_LONG, at = 0; sz >= 0; --sz) {
      const int c = bins[sz];
      bins[sz] = at;
      at += c;
    }
  __syncthreads();
  for (int i = tid; i < carry[1]; i += blockDim.x)
    order[atomicAdd(bins + shorts[i].z - shorts[i].y, 1)] = shorts[i];
  const size_t ned = (size_t)n_e * G.d, tail = sumz ? ned + n_e + 1 : ned;
  for (size_t i = tail + tid; i < (size_t)out_width; i += blockDim.x) out[i] = 0.0f;
  if (!sumz) return;
  const int warp = tid / 32, lane = tid % 32;
  for (int b = warp; b < G.n_rb; b += blockDim.x / 32) {
    const int row0 = b * G.rpb, end = min(G.m, row0 + G.rpb);
    float df = 0.0f;
    for (int rr = row0 + lane; rr < end; rr += 32 * 32) {  // 32 loads in flight, added in order
      float v[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = rr + 32 * j < end ? rowdiff[rr + 32 * j] : 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (rr + 32 * j < end) df += v[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) df += __shfl_xor_sync(FULL, df, o);
    if (lane == 0) dsum[b] = df;
  }
  __syncthreads();
  if (tid == 0) {
    float strip[8] = {};
    for (int b = 0; b < G.n_rb; ++b) strip[b & 7] += dsum[b];
    float s = strip[0];
    for (int w = 1; w < 8; ++w) s += strip[w];
    out[ned + n_e] = s;
  }
}

// Block u: the rows of unit u into sorted, each at its (unit, code) start
// plus its rank among the unit's earlier rows of its code: the rank in its
// warp by __match_any_sync, plus its code's rows in the warps before, from
// a table of each warp's counts in shared memory (a byte a (warp, code),
// up to VQG_TABLE_CODES codes); past that, the warps take turns against
// cursors (in shared memory up to VQG_SMEM_CODES codes, else in hist).
__global__ void __launch_bounds__(VQG_UNIT_ROWS)
vq_group_scatter_kernel(const VqGroup G, const int64_t* __restrict__ idx, int* __restrict__ ws) {
  extern __shared__ int cur_s[];
  int r0, r1;
  unit_rows(G, blockIdx.x, r0, r1);
  if (r0 >= r1) return;  // the block's every thread
  int* hist = ws + G.hist + (size_t)blockIdx.x * G.n_e;
  int* sorted = ws + G.sorted;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, warps = blockDim.x / 32;
  const int row = r0 + tid;
  const int64_t kk = row < r1 ? idx[row] : -1;
  const bool valid = kk >= 0 && kk < G.n_e;
  const int k = valid ? static_cast<int>(kk) : -1;
  const unsigned peers = __match_any_sync(FULL, k);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (G.n_e <= VQG_TABLE_CODES) {
    uint8_t* cnt = reinterpret_cast<uint8_t*>(cur_s);  // [warps][n_e]
    for (int i = tid; i < warps * G.n_e / 4; i += blockDim.x) cur_s[i] = 0;
    __syncthreads();
    if (valid && rank == 0) cnt[warp * G.n_e + k] = static_cast<uint8_t>(__popc(peers));
    __syncthreads();
    if (!valid) return;
    int before = 0;
    for (int w = 0; w < warp; ++w) before += cnt[w * G.n_e + k];
    sorted[hist[k] + before + rank] = row;
    return;
  }
  const bool in_smem = G.n_e <= VQG_SMEM_CODES;
  int* cur = in_smem ? cur_s : hist;
  if (in_smem)
    for (int i = tid; i < G.n_e; i += blockDim.x) cur_s[i] = hist[i];
  for (int w = 0; w < warps; ++w) {
    __syncthreads();
    if (warp == w && valid) {
      const int base = cur[k];
      __syncwarp(peers);  // every peer read the cursor before the first moves it
      if (rank == 0) cur[k] = base + __popc(peers);
      sorted[base + rank] = row;
    }
  }
}

// Walks the sorted rows [p0, p1) in order: add(row, term) with each row's
// term, z or (2 g) (E[k] - z), rounded as the plain version rounds it, G
// rows' loads at once, their ids read by every lane at once (one address)
// a group ahead.
template <int V, int G, bool SUMZ, typename Add>
__device__ __forceinline__ void walk_rows(const int* __restrict__ sorted, int p0, int p1,
                                          const float* __restrict__ z, int d, int col, bool in,
                                          const float (&e)[V], float s, int lane, Add& add) {
  int next[G];
#pragma unroll
  for (int u = 0; u < G; ++u) next[u] = p0 + u < p1 ? __ldg(sorted + p0 + u) : -1;
  for (int p = p0; p < p1; p += G) {
    int r[G];
    float zv[G][V];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      r[u] = next[u];
      if (r[u] >= 0 && in) Cols<V == 4>::load_stream(z + (size_t)r[u] * d + col, zv[u]);
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int q = p + G + u;
      next[u] = q < p1 ? __ldg(sorted + q) : -1;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      if (r[u] < 0) break;  // the same in every lane; the rest are -1 too
      float t[V];
#pragma unroll
      for (int j = 0; j < V; ++j) t[j] = SUMZ ? zv[u][j] : __fmul_rn(s, __fsub_rn(e[j], zv[u][j]));
      add(r[u], t);
    }
  }
}

// A code's sums over all its row blocks: W slots in registers, folded at
// each row block's end into its strip (the warp's 8 strips in shared
// memory: a lane's own columns).
template <int V>
struct ShortAcc {
  float slot[4][V];
  float* strip;  // [8][32 V], this lane's columns at lane * V
  int curb, bend, rpb, W;  // the row block, the first row past it
  __device__ __forceinline__ void fold() {
    float p[V];
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = slot[0][j];
#pragma unroll
    for (int q = 1; q < 4; ++q)
      if (q < W)
#pragma unroll
        for (int j = 0; j < V; ++j) p[j] = __fadd_rn(p[j], slot[q][j]);
    float* at = strip + (curb & 7) * 32 * V;
#pragma unroll
    for (int j = 0; j < V; ++j) at[j] = __fadd_rn(at[j], p[j]);
  }
  __device__ __forceinline__ void operator()(int row, const float (&t)[V]) {
    if (row >= bend) {  // the rows ascend; the same in every lane
      if (curb >= 0) fold();
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < V; ++j) slot[q][j] = 0.0f;
      curb = row / rpb;
      bend = (curb + 1) * rpb;
    }
    const int w = row & (W - 1);  // a row block starts at a multiple of 16
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q == w)
#pragma unroll
        for (int j = 0; j < V; ++j) slot[q][j] = __fadd_rn(slot[q][j], t[j]);
  }
};

// A warp a (short code, column chunk) at a time, taken from a counter in
// the order of the most rows first (dealt to the warps in turn instead, the
// tail of long codes came later): the code's rows in order, its sum written
// once to out[k, :].
template <int V, bool SUMZ>
__global__ void __launch_bounds__(32 * VQG_WARPS, 2)
vq_grouped_sum_kernel(const VqGroup G, const float* __restrict__ z,
                      const float* __restrict__ codebook, const float* __restrict__ g,
                      int* __restrict__ ws, float* __restrict__ out, int n_cc) {
  __shared__ __align__(16) float strips[VQG_WARPS][8 * 32 * V];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* sorted = ws + G.sorted;
  const int4* order = reinterpret_cast<const int4*>(ws + G.order);
  const int units = ws[G.meta] * n_cc;
  const float s = SUMZ ? 1.0f : 2.0f * __ldg(g);  // exact: a power of two
  const int d = G.d;
  float* strip = strips[warp] + lane * V;
  for (;;) {  // the next unit from the counter, the codes with the most rows first
    int su = 0;
    if (lane == 0) su = atomicAdd(ws + G.meta + 2, 1);
    su = __shfl_sync(FULL, su, 0);
    if (su >= units) break;
    const int4 it = order[su / n_cc];
    const int col = (su % n_cc) * 32 * V + lane * V;
    const bool in = col < d;
    float e[V] = {};
    if (!SUMZ && in) Cols<V == 4>::load_ro(codebook + (size_t)it.x * d + col, e);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int j = 0; j < V; ++j) strip[q * 32 * V + j] = 0.0f;
    ShortAcc<V> acc;
    acc.strip = strip, acc.curb = -1, acc.bend = 0, acc.rpb = G.rpb, acc.W = G.W;
    walk_rows<V, VQG_GROUP, SUMZ>(sorted, it.y, it.z, z, d, col, in, e, s, lane, acc);
    if (acc.curb >= 0) acc.fold();
    float r[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      r[j] = strip[j];
#pragma unroll
      for (int q = 1; q < 8; ++q) r[j] = __fadd_rn(r[j], strip[q * 32 * V + j]);
    }
    if (in) Cols<V == 4>::store(out + (size_t)it.x * d + col, r);
  }
}

// A warp a (long code, column chunk, row block, slot) piece, every piece at
// once: the slot's rows of the row block in order (the row block's rows of
// the code, 32 ids at a time, the slot's kept by a ballot and packed into a
// buffer in shared memory, VQG_LONG_GROUP of them loaded at once, all of them
// prefetched into L2 first) into the piece's partial (G.part);
// vq_grouped_fold_kernel adds a code's partials in the order. A code that
// takes most of the rows (a codebook collapsed onto a few codes) is spread
// over every (row block, slot) chain the order has.
template <int V, bool SUMZ>
__global__ void __launch_bounds__(32 * VQG_WARPS)
vq_grouped_piece_kernel(const VqGroup G, const float* __restrict__ z,
                        const float* __restrict__ codebook, const float* __restrict__ g,
                        int* __restrict__ ws, int n_cc) {
  constexpr int GR = VQG_LONG_GROUP;
  __shared__ int kept[VQG_WARPS][GR + 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* buf = kept[warp];
  const int* sorted = ws + G.sorted;
  float* part = reinterpret_cast<float*>(ws + G.part);
  const int W = G.W, pieces = ws[G.meta + 1] * n_cc * G.n_rb * W;
  const float s = SUMZ ? 1.0f : 2.0f * __ldg(g);  // exact: a power of two
  const int d = G.d;
  for (int pc = blockIdx.x * VQG_WARPS + warp; pc < pieces; pc += gridDim.x * VQG_WARPS) {
    const int w = pc % W, b = pc / W % G.n_rb, cc = pc / (W * G.n_rb) % n_cc;
    const int lr = pc / (W * G.n_rb * n_cc);
    const int* lp = ws + G.lpos + (size_t)lr * (G.n_rb + 1);
    const int p0 = lp[b], p1 = lp[b + 1];
    const int col = cc * 32 * V + lane * V, c0 = cc * 32 * V;
    const bool in = col < d;
    float e[V] = {};
    if (!SUMZ && in) Cols<V == 4>::load_ro(codebook + (size_t)ws[G.longs + lr] * d + col, e);
    for (int q = p0 + lane; q < p1; q += 32) {  // the slot's rows on their way to L2
      const int row = __ldg(sorted + q);
      if ((row & (W - 1)) == w)
#pragma unroll
        for (int l = 0; l < V; ++l)
          if (c0 + 32 * l < d)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(z + (size_t)row * d + c0 + 32 * l));
    }
    float acc[V] = {};
    auto add_rows = [&](int n) {  // buf[0, n) in order, their loads at once
      float zv[GR][V];
#pragma unroll
      for (int u = 0; u < GR; ++u)
        if (u < n && in) Cols<V == 4>::load_stream(z + (size_t)buf[u] * d + col, zv[u]);
#pragma unroll
      for (int u = 0; u < GR; ++u) {
        if (u >= n) break;
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = __fadd_rn(acc[j], SUMZ ? zv[u][j] : __fmul_rn(s, __fsub_rn(e[j], zv[u][j])));
      }
    };
    int held = 0;  // rows waiting in buf
    int next = p0 + lane < p1 ? __ldg(sorted + p0 + lane) : -1;
    for (int q0 = p0; q0 < p1; q0 += 32) {
      const int id = next;
      next = q0 + 32 + lane < p1 ? __ldg(sorted + q0 + 32 + lane) : -1;  // a batch ahead
      const bool keep = id >= 0 && (id & (W - 1)) == w;
      const unsigned mask = __ballot_sync(FULL, keep);
      if (keep) buf[held + __popc(mask & ((1u << lane) - 1u))] = id;
      held += __popc(mask);
      __syncwarp();
      while (held >= GR) {  // the same in every lane
        add_rows(GR);
        const int moved = lane < held - GR ? buf[GR + lane] : 0;
        __syncwarp();
        if (lane < held - GR) buf[lane] = moved;
        held -= GR;
        __syncwarp();
      }
    }
    add_rows(held);
    __syncwarp();
    if (in) Cols<V == 4>::store(part + (size_t)pc * 32 * V + lane * V, acc);
  }
}

// A warp a (long code, column chunk): each row block's slot partials in
// slot order, added into strip b % 8 in row-block order, then the strips in
// order, into out[k, :]. (SUMZ only names the instance: a profile tells the
// forward's statistics from the gradient.)
template <int V, bool SUMZ>
__global__ void __launch_bounds__(32 * VQG_WARPS)
vq_grouped_fold_kernel(const VqGroup G, const int* __restrict__ ws, float* __restrict__ out,
                       int n_cc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* part = reinterpret_cast<const float*>(ws + G.part);
  const int units = ws[G.meta + 1] * n_cc;
  for (int u = blockIdx.x * VQG_WARPS + warp; u < units; u += gridDim.x * VQG_WARPS) {
    const int col = u % n_cc * 32 * V + lane * V;
    if (col >= G.d) continue;
    float strip[8][V] = {};
    for (int b = 0; b < G.n_rb; ++b) {
      const float* at = part + ((size_t)u * G.n_rb + b) * G.W * 32 * V + lane * V;
      float p[V], t[V];
      Cols<V == 4>::load(at, p);  // the row block's slots in order
      for (int w = 1; w < G.W; ++w) {
        Cols<V == 4>::load(at + w * 32 * V, t);
#pragma unroll
        for (int j = 0; j < V; ++j) p[j] = __fadd_rn(p[j], t[j]);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q == (b & 7))
#pragma unroll
          for (int j = 0; j < V; ++j) strip[q][j] = __fadd_rn(strip[q][j], p[j]);
    }
    float r[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      r[j] = strip[0][j];
#pragma unroll
      for (int q = 1; q < 8; ++q) r[j] = __fadd_rn(r[j], strip[q][j]);
    }
    Cols<V == 4>::store(out + (size_t)ws[G.longs + u / n_cc] * G.d + col, r);
  }
}

int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms[dev];
}

template <int V, bool SUMZ>
cudaError_t launch_grouped(const VqGroup& G, const float* z, const float* codebook,
                           const float* g, int* ws, float* out, cudaStream_t st) {
  const int n_cc = (G.d + 32 * V - 1) / (32 * V);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  auto grid = [sms](long long upper) {  // persistent: at most 4 blocks an SM
    return (int)(upper < 4LL * sms ? (upper > 0 ? upper : 1) : 4LL * sms);
  };
  vq_grouped_sum_kernel<V, SUMZ><<<2 * sms, 32 * VQG_WARPS, 0, st>>>(G, z, codebook, g, ws, out,
                                                                     n_cc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || G.long_max == 0) return e;
  vq_grouped_piece_kernel<V, SUMZ>
      <<<grid(((long long)G.long_max * n_cc * G.n_rb * G.W + VQG_WARPS - 1) / VQG_WARPS),
         32 * VQG_WARPS, 0, st>>>(G, z, codebook, g, ws, n_cc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  vq_grouped_fold_kernel<V, SUMZ>
      <<<grid(((long long)G.long_max * n_cc + VQG_WARPS - 1) / VQG_WARPS), 32 * VQG_WARPS, 0,
         st>>>(G, ws, out, n_cc);
  return cudaGetLastError();
}

}  // namespace

namespace kvq {

VqGroup vq_group_plan(int m, int d, int n_e, bool vec) {
  VqGroup G{};
  G.m = m, G.d = d, G.n_e = n_e;
  Plan p;
  row_plan(m, d, n_e, &p);
  G.rpb = p.rows_per_block;
  G.n_rb = p.row_blocks;
  G.W = order_warps(d, n_e, vec);
  G.upb = (G.rpb + VQG_UNIT_ROWS - 1) / VQG_UNIT_ROWS;
  G.units = G.n_rb * G.upb;
  G.long_max = n_e < m / (VQG_LONG + 1) ? n_e : m / (VQG_LONG + 1);
  size_t o = 0;
  auto take = [&o](size_t n) {
    const size_t at = o;
    o += (n + 3) & ~size_t(3);  // 16-byte aligned segments
    return at;
  };
  G.hist = take((size_t)G.units * n_e);
  G.sorted = take(m);
  G.shorts = take((size_t)n_e * 4);
  G.order = take((size_t)n_e * 4);
  G.longs = take(G.long_max);
  G.lpos = take((size_t)G.long_max * (G.n_rb + 1));
  G.meta = take(4);
  // the long codes' partials: a piece a (code, column chunk, row block,
  // slot), a float a column of its chunk (chunks of 128 columns, 32 on the
  // element path). Sized for the slots of either path, so that a grouping
  // one path built and sized holds the other's sums (a forward's grouping
  // handed to a backward whose z or codebook is not 16-byte aligned): at
  // most 4 n_e D row blocks, 4 times the bound of the one-pass kernel's
  // partials
  const int slots = std::max(order_warps(d, n_e, true), order_warps(d, n_e, false));
  G.part = take((size_t)G.long_max * G.n_rb * slots * ((d + 127) / 128) * 128);
  G.ints = o;
  return G;
}

bool vq_grouped_takes(int d, int n_e, bool vec) {
  return smem_bytes(CB_WARPS, n_e, chunk_cols(d, vec)) > (size_t)CB_SMEM_MAX;
}

cudaError_t vq_grouped_sum(const VqGroup& G, bool sumz, const float* z, const int64_t* idx,
                           const float* codebook, const float* g, const float* rowdiff, int* ws,
                           float* out, int out_width, bool counted, bool grouped, bool vec,
                           cudaStream_t st) {
  cudaError_t e;
  if (grouped) {  // the grouping as a forward left it: the sums alone
    const size_t ned = (size_t)G.n_e * G.d;
    if (out_width > (int)ned &&
        (e = cudaMemsetAsync(out + ned, 0, (out_width - ned) * sizeof(float), st)) != cudaSuccess)
      return e;
    if ((e = cudaMemsetAsync(ws + G.meta + 2, 0, sizeof(int), st)) != cudaSuccess) return e;
    return vec ? launch_grouped<4, false>(G, z, codebook, g, ws, out, st)
               : launch_grouped<1, false>(G, z, codebook, g, ws, out, st);
  }
  if (!counted) {
    e = cudaMemsetAsync(ws + G.hist, 0, (size_t)G.units * G.n_e * sizeof(int), st);
    if (e != cudaSuccess) return e;
    vq_group_count_kernel<<<G.units, VQG_UNIT_ROWS, 0, st>>>(G, idx, ws);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  vq_group_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(G, ws, out, out_width, rowdiff, sumz ? 1 : 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  static unsigned configured = 0;  // a bit per device whose limit is raised
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if (dev >= 32 || !(configured >> dev & 1u)) {
    e = cudaFuncSetAttribute(vq_group_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             VQG_SMEM_CODES * (int)sizeof(int));
    if (e != cudaSuccess) return e;
    if (dev < 32) configured |= 1u << dev;
  }
  const size_t smem = G.n_e <= VQG_TABLE_CODES  ? (size_t)(VQG_UNIT_ROWS / 32) * G.n_e
                      : G.n_e <= VQG_SMEM_CODES ? (size_t)G.n_e * sizeof(int)
                                                 : 0;
  vq_group_scatter_kernel<<<G.units, VQG_UNIT_ROWS, smem, st>>>(G, idx, ws);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (vec)
    return sumz ? launch_grouped<4, true>(G, z, codebook, g, ws, out, st)
                : launch_grouped<4, false>(G, z, codebook, g, ws, out, st);
  return sumz ? launch_grouped<1, true>(G, z, codebook, g, ws, out, st)
              : launch_grouped<1, false>(G, z, codebook, g, ws, out, st);
}

}  // namespace kvq

extern "C" {

// The ints of the grouping of m rows of d columns by n_e codes (the VQ
// forward's general path leaves it for the codebook gradient).
int kvq_vq_group_ints(int m, int d, int n_e) {
  if (m <= 0 || d <= 0 || n_e <= 0) return 0;
  const size_t ints = kvq::vq_group_plan(m, d, n_e, true).ints;
  return ints > 0x7fffffff ? 0 : static_cast<int>(ints);
}

// plan (2 ints): the scratch's floats (ints on the grouped path), the width
// of out (floats). Returns 0, or cudaErrorInvalidValue for a shape the
// kernel does not take.
int kvq_vq_codebook_grad_plan(int m, int d, int n_e, const void* z, const void* codebook,
                              int* plan) {
  Plan p;
  const bool vec = vec_path(static_cast<const float*>(z), static_cast<const float*>(codebook), d);
  if (!make_plan(m, d, n_e, vec, &p)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t width = round4(n_e * d);
  const size_t ws = kvq::vq_grouped_takes(d, n_e, vec) ? kvq::vq_group_plan(m, d, n_e, vec).ints
                                                        : (size_t)p.row_blocks * width;
  if (ws > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = static_cast<int>(ws), plan[1] = static_cast<int>(width);
  return 0;
}

// z (m, d) f32, idx (m,) int64, codebook (n_e, d) f32, g (1,) f32 on the
// device -> out (width,) f32: dE (n_e, d) | 0 pad. ws: plan[0] floats of
// scratch, 16-byte aligned. group: null, or the grouping of these rows and
// codes that kvq_vq_fwd left (kvq_vq_group_ints ints), which the grouped
// sums then take as it is.
int kvq_vq_codebook_grad(const float* z, const int64_t* idx, const float* codebook,
                         const float* g, float* ws, float* out, const int* group, int m, int d,
                         int n_e, void* stream) {
  Plan p;
  const bool vec = vec_path(z, codebook, d);
  if (!make_plan(m, d, n_e, vec, &p) || !aligned16(ws) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int width = round4(n_e * d);
  if (kvq::vq_grouped_takes(d, n_e, vec))
    return static_cast<int>(kvq::vq_grouped_sum(
        kvq::vq_group_plan(m, d, n_e, vec), false, z, idx, codebook, g, nullptr,
        group != nullptr ? const_cast<int*>(group) : reinterpret_cast<int*>(ws), out, width, false,
        group != nullptr, vec, st));
  const cudaError_t e = vec ? launch<true>(p, st, z, idx, codebook, g, ws, m, d, n_e, width)
                            : launch<false>(p, st, z, idx, codebook, g, ws, m, d, n_e, width);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(kvq::colparts_reduce(ws, p.row_blocks, width, out, st));
}

}  // extern "C"
