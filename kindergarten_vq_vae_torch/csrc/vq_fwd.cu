// VQ-VAE bottleneck forward for Hopper (sm_90a).
//
// Replaces kindergarten_vq_vae_tpu/ops/vq_pallas.py `_vq_kernel` (l.41,
// launched by `_vq_forward_pallas` l.95): in one pass over z it computes
// centered distances, the first-minimum argmin, the z_q gather, per-code
// counts, per-code sums of z and the sum of (z_q - z)^2. It also writes the
// straight-through value z + (z_q - z) of `_fused_vq_core` (l.143), which
// the plain version leaves to two eager passes.
//
// What bounds it on the H100: bytes. At the training step (24,576 rows x
// 768, f32, 9 codes) it reads 75.5 MB of z and writes 75.5 MB of z_q, 45 us
// at 3.35 TB/s, against ~0.5 GF of distance arithmetic; at the serving
// bucket (3,072 rows) the same in an eighth, where launch and set-up
// latency weigh as much. What the design does about it:
// - the codebook work once a call (vq_prep_kernel): the centre c summed in
//   code order, ec = e - c and ||ec||^2; each block stages ec and c with
//   16-byte copies;
// - one warp a pair of rows, the next pair's z loaded (16 bytes a lane, a
//   row's chunks spread over the lanes) while this pair is computed, so z
//   is read once, into registers;
// - the n_e dot products of a row come from one pass over the lane's
//   values, 16 codes at a time (KV of them computed: 12 up to 12 codes,
//   bert-base's 9 among them, else 16), and one transposed reduction: 16 shuffles leave
//   lane l with code l / 2's full sum (the 16 butterflies of the plain way
//   would take 80). Every code's sum goes through the same tree, so two
//   equal codes get the same bits; the centered expansion
//   ||zc||^2 + ||ec||^2 - 2 zc.ec and the strict first minimum stay, so
//   ties break as they do in the oracle;
// - no branch in a pair's loop: a chunk past the row's end, or a code past
//   the last, reads in-bounds data that is masked (shared memory keeps a
//   zeroed tail for it), and the stores past the row's end are predicated
//   off; a branch per chunk or per code serialised every load behind it;
// - the output is the straight-through value z + (e[k] - z) in f32, the
//   same two IEEE operations as the plain version's eager expression, with
//   16-byte stores; indices stay int64;
// - counts, per-code sums of z and the sum of (z_q - z)^2 come from the
//   registers: each warp adds its rows, in order, into its own slab of
//   per-code sums in shared memory (a lane owns its columns: no conflicts,
//   no atomics); counts are integer atomics (exact in any order); the block
//   adds its warps' slabs in warp order into one partial, and
//   colparts_reduce (layernorm.cu) adds the partials in a fixed order over
//   the card. A block takes a number of rows fixed by the row count alone,
//   so the partials, and the bits, depend on the shape alone: two launches
//   give the same bits.
// As many warps as shared memory holds slabs for (up to 8; 7 at 9 x 768, one
// block an SM); the row count sets the rows a block takes so that the grid
// stays within ~128 blocks, one wave on the 132 SMs. What holds it under the
// bound at the step: the instructions of a pair's loop (the FMAs of 12 codes
// for bert-base's 9, the masks, the reductions, the address arithmetic),
// issued by only 7 warps an SM, and the gather of the chosen code rows from
// L1 / L2 after the argmin.
//
// The general path: a codebook whose per-code slabs do not fit in shared
// memory beside it (above ~37 codes at D = 768), or D above 1,024. There the
// distances are a product of z's rows and the codebook, which at 512 codes
// x 768 x 24,576 rows is 19.3 GFLOP of f32 FMA (0.29 ms at 67 TFLOP/s)
// against 0.045 ms of bytes: the operations bound it. What it does:
// - vq_center_kernel and vq_esq_kernel prepare c, ec and ||ec||^2 as
//   vq_prep_kernel does (c summed in code order; ||ec||^2 lane-strided,
//   then the butterfly), over any D and any codebook;
// - vq_dist_kernel: a block takes 64 rows and streams the centred codebook
//   through shared memory, 64 codes x 32 columns at a time, beside the
//   same 32 columns of its rows' z - c; each of 256 threads sums 4 rows x 4
//   codes over D in order with FMAs (f32 on the CUDA cores: a TF32 or
//   tensor-core distance would move the argmin off JAX's), forms the
//   centred distance ||zc||^2 + ||ec||^2 - 2 zc.ec and keeps its first
//   minimum with a strict < in code order; the 16 threads of a row then
//   take the smaller distance, on equal distances the lower code: the first
//   minimum over the codebook. The block then writes z_q = z + (e[k] - z)
//   and each row's sum of (z_q - z)^2, a warp a row;
// - kvq::vq_sums (vq_bwd.cu) forms the per-code sums of z, the counts and
//   the sum of the rows' (z_q - z)^2 in a fixed order, by code chunks, and
//   colparts_reduce sums its partials: two launches give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "layernorm.cuh"

namespace kvq {
// vq_bwd.cu: the fixed-order per-code statistics of the general path
int vq_sums_row_blocks(int m, int d, int n_e);
cudaError_t vq_sums(const float* z, const int64_t* idx, const float* rowdiff, float* parts,
                    float* out, int m, int d, int n_e, cudaStream_t st);
}  // namespace kvq

namespace {

constexpr int VQ_MAX_WARPS = 8;
constexpr int VQ_MAX_DIM = 1024;        // a row in 32 registers a lane
constexpr int VQ_GROUP = 16;            // codes a transposed reduction
constexpr int VQ_TARGET_BLOCKS = 128;   // blocks a call aims at (sets the rows a block)
constexpr int VQ_SMEM_MAX = 232448;     // dynamic shared memory a Hopper block may use
constexpr int PREP_THREADS = 1024;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats of shared memory: ec [r4(n_e d)] | c [r4(d)] | W slabs [r4(n_e d)] |
// counts [r4(n_e) ints] | per-warp diff [W], and past the slabs at least as
// many floats as a lane's last 16-byte chunk may run past a row's end
// (128 ceil(d / 128) - d: 0 at d = 768), all but ec and c zeroed: such a
// chunk of ec, c or a slab reads finite values there, masked and never
// stored. The element path clamps its chunks to the row instead. The prep
// buffer in global memory starts with the same ec and c, then ||ec||^2
// [r4(n_e)].
struct Layout {
  int ned, c, slabs, cnt, wdiff, floats;
  __host__ __device__ Layout(int d, int n_e, int warps)
      : ned(round4(n_e * d)), c(ned), slabs(c + round4(d)), cnt(slabs + warps * ned),
        wdiff(cnt + round4(n_e)),
        floats(round4(wdiff + warps) > cnt + overrun(d) ? round4(wdiff + warps)
                                                        : cnt + overrun(d)) {}
  __host__ __device__ static int overrun(int d) { return d % 4 ? 0 : 128 * ((d + 127) / 128) - d; }
};

int warps_for(int d, int n_e) {
  for (int w = VQ_MAX_WARPS; w >= 1; --w)
    if (Layout(d, n_e, w).floats * sizeof(float) <= static_cast<size_t>(VQ_SMEM_MAX)) return w;
  return 0;
}

struct Plan {
  int warps, rows_per_block, blocks, part_width, prep_floats;
};

// 0 when the shape is refused (no rows, columns or codes). warps 0: the
// general path, whose blocks are kvq::vq_sums's partials and whose prep
// buffer ends with the rows' (z_q - z)^2 (round4(m) floats).
int make_plan(int m, int d, int n_e, Plan* p) {
  if (m <= 0 || d <= 0 || n_e <= 0) return 0;
  p->warps = d <= VQ_MAX_DIM ? warps_for(d, n_e) : 0;
  if (p->warps == 0) {
    p->rows_per_block = 0;
    p->blocks = kvq::vq_sums_row_blocks(m, d, n_e);
    p->part_width = round4(n_e * d + n_e + 1);
    p->prep_floats = round4(n_e * d) + round4(d) + round4(n_e) + round4(m);
    return 1;
  }
  const int per_block = 2 * p->warps;  // a pair of rows a warp at a time
  const int pairs = (m + per_block * VQ_TARGET_BLOCKS - 1) / (per_block * VQ_TARGET_BLOCKS);
  p->rows_per_block = per_block * pairs;
  p->blocks = (m + p->rows_per_block - 1) / p->rows_per_block;
  p->part_width = round4(n_e * d + n_e + 1);  // sum_z | counts | diff | 0 pad
  p->prep_floats = round4(n_e * d) + round4(d) + round4(n_e);
  return 1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c (the codebook's mean, summed in code order), ec = e - c and
// esq = ||ec||^2 into prep (see Layout); one block.
__global__ void __launch_bounds__(PREP_THREADS)
vq_prep_kernel(const float* __restrict__ e, float* __restrict__ prep, int d, int n_e) {
  __shared__ float cs[VQ_MAX_DIM];
  const Layout L(d, n_e, 0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int c = tid; c < d; c += PREP_THREADS) {
    float s = 0.0f;
    for (int k = 0; k < n_e; ++k) s += e[(size_t)k * d + c];
    cs[c] = s / n_e;
    prep[L.c + c] = cs[c];
  }
  __syncthreads();
  for (int i = tid; i < n_e * d; i += PREP_THREADS) prep[i] = e[i] - cs[i % d];
  float* esq = prep + L.slabs;  // the prep buffer's third part
  for (int k = warp; k < n_e; k += PREP_THREADS / 32) {
    float s = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float t = e[(size_t)k * d + c] - cs[c];
      s = fmaf(t, t, s);
    }
    s = warp_sum(s);
    if (lane == 0) esq[k] = s;
  }
}

// A lane's V columns of chunk t: (lane + 32 t) * V .. + V.
template <bool VEC>
struct Chunk {
  static constexpr int V = VEC ? 4 : 1;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    if constexpr (VEC) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      v[0] = *p;
    }
  }
  // z: read once, past L1 (which keeps the codebook), 256-byte L2 fetches
  __device__ __forceinline__ static void load_stream(const float* p, float* v) {
    if constexpr (VEC) {
      asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
          : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
          : "l"(p));
    } else {
      v[0] = __ldcs(p);
    }
  }
  // the raw codebook's rows: kept in L1
  __device__ __forceinline__ static void load_ro(const float* p, float* v) {
    if constexpr (VEC) {
      asm("ld.global.nc.L1::evict_last.v4.f32 {%0, %1, %2, %3}, [%4];"
          : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
          : "l"(p));
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

// One step of transpose_sum: lanes with bit 2H set keep v[H..2H) and send
// v[0..H) to the lane across that bit, which keeps v[0..H); each adds what
// it gets.
template <int H>
__device__ __forceinline__ void keep_half(float (&v)[VQ_GROUP], int lane) {
  const bool up = (lane & (2 * H)) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

// The 16 partial sums v[] of each lane, summed over the warp: lane l ends
// with code (l >> 1) & 15's sum. Every code goes through the same tree
// (lane bits 4, 3, 2, 1, then 0) with its operands in either order.
__device__ __forceinline__ float transpose_sum(float (&v)[VQ_GROUP], int lane) {
  static_assert(VQ_GROUP == 16, "four halvings, then lanes 2j and 2j + 1");
  keep_half<8>(v, lane);
  keep_half<4>(v, lane);
  keep_half<2>(v, lane);
  keep_half<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// The first minimum of (dist, code) over the warp (lanes 2j and 2j + 1
// hold the same code): the smaller distance, and on equal distances the
// lower code.
__device__ __forceinline__ void warp_argmin(float& bd, int& bk) {
#pragma unroll
  for (int o = 16; o > 1; o >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, bd, o);
    const int ok = __shfl_xor_sync(0xffffffffu, bk, o);
    if (od < bd || (od == bd && ok < bk)) bd = od, bk = ok;
  }
}

// The offset of a lane's chunk t from its first column: on the 16-byte
// path 128 t floats (an immediate; a chunk past the row reads the padded
// tail); on the element path chunks past the row read column 0 instead.
template <bool VEC>
__device__ __forceinline__ int chunk_off(int t, int lane, int d) {
  return VEC || lane + 32 * t < d ? 32 * Chunk<VEC>::V * t : -lane;
}

// z - c of a chunk of rows a and b, 0 past the row's end.
template <bool VEC>
__device__ __forceinline__ void centred(const float* za, const float* zb, const float* c_at,
                                        bool in, float* ua, float* ub) {
  constexpr int V = Chunk<VEC>::V;
  float c[V];
  Chunk<VEC>::load(c_at, c);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ua[j] = in ? za[j] - c[j] : 0.0f;
    ub[j] = in ? zb[j] - c[j] : 0.0f;
  }
}

// Rows r and rb of z into a lane's chunks; past the row's end the load
// reads the row's first chunk (masked where it is used), so there is no
// branch and every load of the pair is in flight at once.
template <int CPL, bool VEC>
__device__ __forceinline__ void load_pair(const float* __restrict__ z, int r, int rb, int d,
                                          int lane, float (&a)[CPL * Chunk<VEC>::V],
                                          float (&b)[CPL * Chunk<VEC>::V]) {
  constexpr int V = Chunk<VEC>::V;
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int col = (lane + 32 * t) * V, at = col < d ? col : 0;
    Chunk<VEC>::load_stream(z + (size_t)r * d + at, a + t * V);
    Chunk<VEC>::load_stream(z + (size_t)rb * d + at, b + t * V);
  }
}

// CPL chunks of V floats a lane hold a row (CPL * V * 32 >= d); the dot
// products take KV codes of a group of 16 (12 up to 12 codes, else 16), the
// others stay 0 and are masked.
template <int CPL, bool VEC, int KV>
__global__ void __launch_bounds__(32 * VQ_MAX_WARPS)
vq_assign_kernel(const float* __restrict__ z, const float* __restrict__ codebook,
                 const float* __restrict__ prep, float* __restrict__ zq, int64_t* __restrict__ idx,
                 float* __restrict__ parts, int m, int d, int n_e, int rows_per_block,
                 int part_width) {
  typedef Chunk<VEC> C;
  constexpr int V = C::V, N = CPL * V;
  extern __shared__ __align__(16) float smem[];
  const int W = blockDim.x / 32, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Layout L(d, n_e, W);
  const float* ec = smem + lane * V;  // this lane's columns from here on
  const float* cs = smem + L.c + lane * V;
  float* slab = smem + L.slabs + warp * L.ned + lane * V;
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  const float* esq = prep + L.slabs;

  // stage ec and c; zero the slabs and counts
  {
    const float4* src = reinterpret_cast<const float4*>(prep);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int i = tid; i < L.slabs / 4; i += blockDim.x) dst[i] = src[i];
    for (int i = L.slabs / 4 + tid; i < L.floats / 4; i += blockDim.x)
      dst[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  const int row0 = blockIdx.x * rows_per_block;
  const int end = min(m, row0 + rows_per_block);
  float wd = 0.0f;  // this warp's sum of (z_q - z)^2, its rows in order
  float za[N], zb[N], na[N], nb[N];

  // ||ec||^2 of this lane's code in the first group, read once
  const float q0 = __ldg(esq + min((lane >> 1) & (VQ_GROUP - 1), n_e - 1));
  int r = row0 + 2 * warp;
  if (r < end) load_pair<CPL, VEC>(z, r, min(r + 1, end - 1), d, lane, na, nb);
  for (; r < end; r += 2 * W) {
#pragma unroll
    for (int i = 0; i < N; ++i) za[i] = na[i], zb[i] = nb[i];
    if (r + 2 * W < end)  // in flight while this pair is computed
      load_pair<CPL, VEC>(z, r + 2 * W, min(r + 2 * W + 1, end - 1), d, lane, na, nb);
    const bool has_b = r + 1 < end;  // else row b repeats row a and is not written

    // ||z - c||^2: a lane's sum in V interleaved parts (short chains), then
    // the butterfly (every lane the same bits)
    float sa = 0.0f, sb = 0.0f;
    {
      float pa[V], pb[V];
#pragma unroll
      for (int j = 0; j < V; ++j) pa[j] = 0.0f, pb[j] = 0.0f;
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        float ua[V], ub[V];
        centred<VEC>(za + t * V, zb + t * V, cs + chunk_off<VEC>(t, lane, d),
                     (lane + 32 * t) * V < d, ua, ub);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          pa[j] = fmaf(ua[j], ua[j], pa[j]);
          pb[j] = fmaf(ub[j], ub[j], pb[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) sa += pa[j], sb += pb[j];
    }
    sa = warp_sum(sa);
    sb = warp_sum(sb);

    // the dot products with 16 codes at a time; past the last code the group
    // repeats it (no branch), and those lanes' distances are +inf
    float best_a = 0.0f, best_b = 0.0f;
    int ka = 0, kb = 0;
    for (int g0 = 0; g0 < n_e; g0 += VQ_GROUP) {
      float pa[VQ_GROUP], pb[VQ_GROUP];
#pragma unroll
      for (int k = 0; k < VQ_GROUP; ++k) pa[k] = 0.0f, pb[k] = 0.0f;
      const float* ek[KV];  // past the last code the group repeats it
#pragma unroll
      for (int k = 0; k < KV; ++k) ek[k] = ec + min(g0 + k, n_e - 1) * d;
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int off = chunk_off<VEC>(t, lane, d);
        float ua[V], ub[V], e[KV][V];
        centred<VEC>(za + t * V, zb + t * V, cs + off, (lane + 32 * t) * V < d, ua, ub);
#pragma unroll
        for (int k = 0; k < KV; ++k) C::load(ek[k] + off, e[k]);
        // the codes innermost: neighbouring FMAs are independent; each code's
        // sum still runs over its columns in the lane's order
#pragma unroll
        for (int j = 0; j < V; ++j) {
#pragma unroll
          for (int k = 0; k < KV; ++k) {
            pa[k] = fmaf(ua[j], e[k][j], pa[k]);
            pb[k] = fmaf(ub[j], e[k][j], pb[k]);
          }
        }
      }
      const float ca = transpose_sum(pa, lane), cb = transpose_sum(pb, lane);
      const int k = g0 + ((lane >> 1) & (VQ_GROUP - 1));
      const float q = g0 == 0 ? q0 : __ldg(esq + min(k, n_e - 1));
      const float inf = __int_as_float(0x7f800000);
      float da = k < n_e ? sa + q - 2.0f * ca : inf;
      float db = k < n_e ? sb + q - 2.0f * cb : inf;
      int kga = k, kgb = k;
      warp_argmin(da, kga);
      warp_argmin(db, kgb);
      if (g0 == 0 || da < best_a) best_a = da, ka = kga;  // strict: the first minimum wins
      if (g0 == 0 || db < best_b) best_b = db, kb = kgb;
    }

    // z_q = e[k]: the code rows' loads first; while they are in flight, the
    // per-code sums (row b after row a: they may share a code); then the
    // straight-through value and (z_q - z)^2. Stores past the row's end are
    // predicated off.
    float qa[N], qb[N];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int col = (lane + 32 * t) * V, at = col < d ? col : 0;
      C::load_ro(codebook + (size_t)ka * d + at, qa + t * V);
      C::load_ro(codebook + (size_t)kb * d + at, qb + t * V);
    }
    // the per-code sums: both rows' slab chunks loaded first; when the rows
    // share a code, row b adds to row a's sum (the rows in order)
    float* sa_k = slab + ka * d;
    float* sb_k = slab + kb * d;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const bool in = (lane + 32 * t) * V < d;
      const int off = chunk_off<VEC>(t, lane, d);
      float s[V], u[V];
      C::load(sa_k + off, s);
      C::load(sb_k + off, u);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += za[t * V + j];
        u[j] = (ka == kb ? s[j] : u[j]) + zb[t * V + j];
      }
      if (in) C::store(sa_k + off, s);
      if (in && has_b) C::store(sb_k + off, u);
    }
    float dfa = 0.0f, dfb = 0.0f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int col = (lane + 32 * t) * V;
      const bool in = col < d;
      float oa[V], ob[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float ea = in ? qa[t * V + j] - za[t * V + j] : 0.0f;
        const float eb = in ? qb[t * V + j] - zb[t * V + j] : 0.0f;
        oa[j] = za[t * V + j] + ea;
        ob[j] = zb[t * V + j] + eb;
        dfa = fmaf(ea, ea, dfa);
        dfb = fmaf(eb, eb, dfb);
      }
      if (in) C::store(zq + (size_t)r * d + col, oa);
      if (in && has_b) C::store(zq + (size_t)(r + 1) * d + col, ob);
    }
    dfa = warp_sum(dfa);
    dfb = warp_sum(dfb);
    wd += dfa;
    if (has_b) wd += dfb;
    if (lane == 0) {
      idx[r] = ka;
      atomicAdd(cnt + ka, 1);
      if (has_b) {
        idx[r + 1] = kb;
        atomicAdd(cnt + kb, 1);
      }
    }
  }
  if (lane == 0) smem[L.wdiff + warp] = wd;
  __syncthreads();

  // the block's partial: the warps' slabs in warp order, counts, diff, 0 pad
  float* out = parts + (size_t)blockIdx.x * part_width;
  const int ne_d = n_e * d;
  for (int i = tid * V; i < ne_d; i += blockDim.x * V) {
    float s[V], t[V];
    C::load(smem + L.slabs + i, s);
    for (int w = 1; w < W; ++w) {
      C::load(smem + L.slabs + w * L.ned + i, t);
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] += t[j];
    }
    C::store(out + i, s);
  }
  for (int i = ne_d + tid; i < part_width; i += blockDim.x) {
    float v = 0.0f;
    if (i < ne_d + n_e) {
      v = static_cast<float>(cnt[i - ne_d]);
    } else if (i == ne_d + n_e) {
      for (int w = 0; w < W; ++w) v += smem[L.wdiff + w];
    }
    out[i] = v;
  }
}

// Launches vq_assign_kernel<CPL, VEC, KV>; raises its shared-memory limit
// once per device.
template <int CPL, bool VEC, int KV>
cudaError_t launch_assign(const Plan& p, size_t smem, cudaStream_t st, const float* z,
                          const float* codebook, const float* prep, float* zq, int64_t* idx,
                          float* parts, int m, int d, int n_e) {
  auto* kernel = vq_assign_kernel<CPL, VEC, KV>;
  static unsigned configured = 0;  // a bit per device whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(configured >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, VQ_SMEM_MAX);
    if (e != cudaSuccess) return e;
    if (dev < 32) configured |= 1u << dev;
  }
  kernel<<<p.blocks, 32 * p.warps, smem, st>>>(z, codebook, prep, zq, idx, parts, m, d, n_e,
                                               p.rows_per_block, p.part_width);
  return cudaGetLastError();
}

// ------------------------------------------------ the general path

constexpr int VQD_ROWS = 64, VQD_CODES = 64, VQD_COLS = 32;  // a block's tile
constexpr int VQD_THREADS = 256;  // 16 x 16: rows ty + 16 i, codes tx + 16 j

// c (the codebook's mean, summed in code order) and ec = e - c into prep;
// a thread a column.
__global__ void __launch_bounds__(256)
vq_center_kernel(const float* __restrict__ e, float* __restrict__ prep, int d, int n_e) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.0f;
  for (int k = 0; k < n_e; ++k) s += e[(size_t)k * d + c];
  const float cs = s / n_e;
  prep[round4(n_e * d) + c] = cs;
  for (int k = 0; k < n_e; ++k) prep[(size_t)k * d + c] = e[(size_t)k * d + c] - cs;
}

// ||ec||^2 of each code, a warp a code (as vq_prep_kernel sums it)
__global__ void __launch_bounds__(256) vq_esq_kernel(float* __restrict__ prep, int d, int n_e) {
  const int k = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (k >= n_e) return;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float t = prep[(size_t)k * d + c];
    s = fmaf(t, t, s);
  }
  s = warp_sum(s);
  if (lane == 0) prep[round4(n_e * d) + round4(d) + k] = s;
}

// Block: rows [64 b, +64). idx, z_q (the straight-through value) and each
// row's sum of (z_q - z)^2 into rowdiff.
__global__ void __launch_bounds__(VQD_THREADS)
vq_dist_kernel(const float* __restrict__ z, const float* __restrict__ codebook,
               const float* __restrict__ prep, float* __restrict__ zq, int64_t* __restrict__ idx,
               float* __restrict__ rowdiff, int m, int d, int n_e) {
  __shared__ float zs[VQD_ROWS][VQD_COLS + 1];   // z - c
  __shared__ float es[VQD_CODES][VQD_COLS + 1];  // ec
  __shared__ float sa_s[VQD_ROWS];               // ||z - c||^2
  __shared__ int k_s[VQD_ROWS];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * VQD_ROWS;
  const float* ec = prep;
  const float* cen = prep + round4(n_e * d);
  const float* esq = cen + round4(d);

  float bd[4], sa = 0.0f;  // sa: row tid's ||z - c||^2 (tid < 64)
  int bk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) bd[i] = __int_as_float(0x7f800000), bk[i] = 0;
  for (int k0 = 0; k0 < n_e; k0 += VQD_CODES) {
    float acc[4][4] = {};
    for (int c0 = 0; c0 < d; c0 += VQD_COLS) {
      __syncthreads();
      for (int e = tid; e < VQD_ROWS * VQD_COLS; e += VQD_THREADS) {
        const int r = e / VQD_COLS, c = e % VQD_COLS, col = c0 + c;
        const int row = row0 + r, code = k0 + r;
        zs[r][c] = row < m && col < d ? z[(size_t)row * d + col] - cen[col] : 0.0f;
        es[r][c] = code < n_e && col < d ? ec[(size_t)code * d + col] : 0.0f;
      }
      __syncthreads();
      if (k0 == 0 && tid < VQD_ROWS)
        for (int c = 0; c < VQD_COLS; ++c) sa = fmaf(zs[tid][c], zs[tid][c], sa);
#pragma unroll 8
      for (int c = 0; c < VQD_COLS; ++c) {
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = zs[ty + 16 * i][c], y[i] = es[tx + 16 * i][c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
    }
    if (k0 == 0) {
      if (tid < VQD_ROWS) sa_s[tid] = sa;
      __syncthreads();
    }
    // this thread's codes in increasing order: strict <, the first minimum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = sa_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx + 16 * j;
        if (k < n_e) {
          const float dist = s + esq[k] - 2.0f * acc[i][j];
          if (dist < bd[i]) bd[i] = dist, bk[i] = k;
        }
      }
    }
  }
  // over the 16 threads of a row: the smaller distance, on equal ones the lower code
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd[i], o);
      const int ok = __shfl_xor_sync(0xffffffffu, bk[i], o);
      if (od < bd[i] || (od == bd[i] && ok < bk[i])) bd[i] = od, bk[i] = ok;
    }
    if (tx == 0) {
      const int r = ty + 16 * i;
      k_s[r] = bk[i];
      if (row0 + r < m) idx[row0 + r] = bk[i];
    }
  }
  __syncthreads();

  // z_q = z + (e[k] - z) and the row's sum of (z_q - z)^2, a warp a row
  for (int r = warp; r < VQD_ROWS; r += VQD_THREADS / 32) {
    const int row = row0 + r;
    if (row >= m) break;
    const float* q = codebook + (size_t)k_s[r] * d;
    float df = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float zz = z[(size_t)row * d + c], ea = q[c] - zz;
      zq[(size_t)row * d + c] = zz + ea;
      df = fmaf(ea, ea, df);
    }
    df = warp_sum(df);
    if (lane == 0) rowdiff[row] = df;
  }
}

cudaError_t vq_general(const Plan& p, cudaStream_t st, const float* z, const float* codebook,
                       float* zq, int64_t* idx, float* ws, float* stats, int m, int d, int n_e) {
  float* prep = ws;
  float* rowdiff = ws + round4(n_e * d) + round4(d) + round4(n_e);
  float* parts = ws + p.prep_floats;
  vq_center_kernel<<<(d + 255) / 256, 256, 0, st>>>(codebook, prep, d, n_e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  vq_esq_kernel<<<(n_e + 7) / 8, 256, 0, st>>>(prep, d, n_e);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  vq_dist_kernel<<<(m + VQD_ROWS - 1) / VQD_ROWS, VQD_THREADS, 0, st>>>(z, codebook, prep, zq,
                                                                       idx, rowdiff, m, d, n_e);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return kvq::vq_sums(z, idx, rowdiff, parts, stats, m, d, n_e, st);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

extern "C" {

// plan (5 ints): warps a block (0: the general path), rows a block, blocks
// (partials), the width of a partial and of the stats (floats), the prep
// buffer's floats. Returns 0, or cudaErrorInvalidValue for an empty shape.
int kvq_vq_plan(int m, int d, int n_e, int* plan) {
  Plan p;
  if (!make_plan(m, d, n_e, &p)) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.warps, plan[1] = p.rows_per_block, plan[2] = p.blocks, plan[3] = p.part_width;
  plan[4] = p.prep_floats;
  return 0;
}

// z (m, d) f32, codebook (n_e, d) f32 -> zq (m, d) f32, the straight-through
// value z + (codebook[idx] - z); idx (m,) int64; stats (part_width,) f32:
// sum_z (n_e, d) | counts (n_e) | diff (1) | 0 pad. ws: prep_floats +
// blocks * part_width floats of scratch, 16-byte aligned.
int kvq_vq_fwd(const float* z, const float* codebook, float* zq, int64_t* idx, float* ws,
               float* stats, int m, int d, int n_e, void* stream) {
  Plan p;
  if (!make_plan(m, d, n_e, &p) || !aligned16(ws)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.warps == 0)
    return static_cast<int>(vq_general(p, st, z, codebook, zq, idx, ws, stats, m, d, n_e));
  float* prep = ws;
  float* parts = ws + p.prep_floats;
  vq_prep_kernel<<<1, PREP_THREADS, 0, st>>>(codebook, prep, d, n_e);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = Layout(d, n_e, p.warps).floats * sizeof(float);
  const bool vec = d % 4 == 0 && aligned16(z) && aligned16(codebook) && aligned16(zq);
  if (!vec) {
    e = launch_assign<32, false, 16>(p, smem, st, z, codebook, prep, zq, idx, parts, m, d, n_e);
  } else {
#define KVQ_VQ(C, K) \
  e = launch_assign<C, true, K>(p, smem, st, z, codebook, prep, zq, idx, parts, m, d, n_e)
#define KVQ_VQ_KV(C) \
  if (n_e <= 12) KVQ_VQ(C, 12); else KVQ_VQ(C, 16)
    switch ((d + 127) / 128) {
      case 1: KVQ_VQ_KV(1); break;
      case 2: KVQ_VQ_KV(2); break;
      case 3: KVQ_VQ_KV(3); break;
      case 4: KVQ_VQ_KV(4); break;
      case 5: KVQ_VQ_KV(5); break;
      case 6: KVQ_VQ_KV(6); break;
      case 7: KVQ_VQ_KV(7); break;
      default: KVQ_VQ_KV(8); break;
    }
#undef KVQ_VQ_KV
#undef KVQ_VQ
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(kvq::colparts_reduce(parts, p.blocks, p.part_width, stats, st));
}

}  // extern "C"
