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
// distances are a product of z's rows and the codebook, 19.3 GFLOP at 512
// codes x 768 x 24,576 rows: 0.29 ms at the f32 FMA peak (67 TFLOP/s), 0.117
// ms as 3xTF32 on the tensor cores (3 x 19.3 GFLOP at 495 TFLOP/s), against
// 0.045 ms of bytes; the operations bound it. The codes must be those of
// the in-order f32 sums of the CUDA-core kernel this path replaced
// (vq_dist_kernel: each distance s + q - 2 cross, s =
// ||z - c||^2 and cross = (z - c) . (e_k - c) summed over D in column order
// with fmaf, q = ||e_k - c||^2 lane-strided, then the butterfly; the first
// minimum, on equal distances the lower code), so the tensor cores only
// screen out the codes that cannot be the minimum:
// - vq_centre_kernel sums c in code order and vq_ec_kernel forms ec = e - c
//   and q as that kernel did (the same bits), ec at a stride of round4(D);
// - the distances' products cross' = (z - c) . ec on the f32 GEMM
//   (gemm_f32.cu, EPI_VQ_CROSS: wgmma with TMA, 3xTF32, each element of z
//   centred by the same f32 subtraction as it is split, so z is read from
//   HBM once and no centred copy is written), into a scratch of 2^22
//   floats (8,192 rows at 512 codes): the GEMM and the pick kernel below
//   take the rows a chunk at a time, in turns;
// - vq_pick_kernel, 16 rows a block (8 past D 790; four blocks an SM),
//   stages its rows of z in shared memory; a warp a row reads its row of
//   cross' (prefetched into L2, one batch of loads), forms t'_k = q_k
//   - 2 cross'_k and the bound M_k below, U = min_k (t'_k + M_k) (rounded up)
//   and keeps the codes with t'_k - M_k <= U (rounded down), in code order;
//   then one thread a sum recomputes, in the old kernel's exact order, s for
//   each row and cross for each kept code, and each row takes the first
//   minimum of s + q_k - 2 cross_k over them. A row that keeps more than 16
//   codes, or whose bound is not finite, rechecks every code the same way.
//   Then z_q = z + (e[k] - z) with 16-byte stores, each row's sum of (z_q -
//   z)^2 in the old kernel's lane order, and the row's code counted for the
//   grouping below;
// - the per-code sums of z, the counts and the sum of the rows' (z_q - z)^2
//   are the grouped sums of vq_bwd.cu (vq_group.cuh) in the order of the
//   kernels before them: two launches give the same bits, the same as the
//   CUDA-core path's; the grouping is left to the codebook gradient.
//
// Why the screen is exact (the bound). For a row x = z - c and a code y =
// e_k - c (both f32, the same values on both sides), with S = sum_j |x_j
// y_j| <= ||x|| ||y|| and u = 2^-24:
// - the TF32 split (cvt.rna twice: x = big + small + r, |r| <= 2^-22 |x|)
//   drops small*small and the remainders' products: <= 2^-20 S;
// - the tensor cores add a 32-deep slice's 96 products into a fresh
//   accumulator in an order and with a rounding NVIDIA does not document:
//   taking each of at most 128 adds a slice as losing one ulp of a value no
//   larger than the slice's sum of |terms| (at most (1 + 2^-9) S), <= 2^-16
//   (1 + 2^-9) S over all slices; one rounded FADD a slice adds
//   ceil(D / 32) u (1 + 2^-9) S;
// - the old kernel's own D fmaf roundings: <= D u S.
// So |cross' - cross| <= kappa0 ||x|| ||y||, kappa0 = 2^-20 + (1 + 2^-9)
// (2^-16 + ceil(D / 32) u) + D u (6.35e-5 at D = 768). The distances share
// s within a row; the old kernel's s + q - 2 cross and t' round at most
// 3 u (||x|| + ||y||)^2 apart beyond 2 |cross' - cross|. With a safety factor
// of 2 on both (kappa = 2 kappa0, 1.27e-4 at D = 768):
//   M_k = 2 kappa ||x|| ||y|| + 2^-21 (||x|| + ||y||)^2
// bounds |(dist_k - s) - t'_k| (||x|| from a warp sum, ||y|| from q: their
// few ulps lie inside the factor 2). A code left out has dist_k - s >= t'_k -
// M_k > U >= min_k (dist_k - s), so it is not a minimum; every minimum is
// kept. The codes are the old kernel's bit for bit on every row: duplicate
// codes, rows far from the origin near close codes, near ties. On random
// rows at 512 codes most rows recheck one code.

#include <cuda_runtime.h>

#include <cstdint>

#include "gemm_f32.cuh"
#include "layernorm.cuh"
#include "vq_group.cuh"

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

// ------------------------------------------------ the general path's plan

constexpr int GP_THREADS = 128;                   // the pick kernel: 4 warps
constexpr int GP_CAP = 16;                        // codes a row keeps before it rechecks them all
constexpr int GP_SMEM = 55 * 1024;                // the pick kernel's shared memory: four blocks an SM
constexpr int GP_BATCH = 16;                      // loads a lane issues at once
constexpr int GP_OUT = 8;                         // z_q's 16-byte chunks a lane takes at once
constexpr long long GP_CROSS_FLOATS = 1LL << 22;  // the products of a chunk of rows (16 MiB)

__host__ __device__ constexpr int round32(int n) { return (n + 31) & ~31; }

// The pick kernel's shared memory (words): R staged rows of z at ldz and
// the centre (ldk), then a row's s, candidates, code and task offset, and
// its kept codes and their sums
size_t pick_words(int R, bool staged, int ldz, int ldk) {
  return (staged ? (size_t)R * ldz + ldk : 0) + 4 * (size_t)R + 4 + 2 * (size_t)R * GP_CAP;
}

// The general path's plan and its scratch, in floats of ws: ec (n_pad x
// ldk), the centre (round32(d), 0 past d), q (n_pad), the rows' (z_q - z)^2
// (m), the products of a chunk of rows (chunk x n_pad), z at a stride of ldk
// where d % 4 != 0 (the GEMM's 16-byte rows), then the grouping's ints.
struct General {
  int ldk, n_pad, cenlen, chunk, R, ldz;
  bool staged, zpad;
  size_t ec, cen, esq, rowdiff, cross, zp, group, floats;
};

General general_plan(int m, int d, int n_e) {
  General P{};
  P.ldk = round4(d), P.n_pad = round4(n_e), P.cenlen = round32(d);
  long long chunk = GP_CROSS_FLOATS / P.n_pad / 128 * 128;
  P.chunk = (int)(chunk < 128 ? 128 : chunk > m ? m : chunk);
  P.zpad = d % 4 != 0;
  P.ldz = P.ldk + 4;  // a row 4 banks on from the one before
  P.R = 4, P.staged = false;
  for (int R = 16; R >= 4; R /= 2)
    if (pick_words(R, true, P.ldz, P.ldk) * sizeof(float) <= (size_t)GP_SMEM) {
      P.R = R, P.staged = true;
      break;
    }
  size_t o = 0;
  auto take = [&o](size_t n) {
    const size_t at = o;
    o += (n + 3) & ~size_t(3);  // 16-byte aligned segments
    return at;
  };
  P.ec = take((size_t)P.n_pad * P.ldk);
  P.cen = take(P.cenlen);
  P.esq = take(P.n_pad);
  P.rowdiff = take(m);
  P.cross = take((size_t)P.chunk * P.n_pad);
  P.zp = take(P.zpad ? (size_t)m * P.ldk : 0);
  P.group = take(kvq::vq_group_plan(m, d, n_e, true).ints);
  P.floats = o;
  return P;
}

// 0 when the shape is refused (no rows, columns or codes, or a general
// path's scratch past 2^31 floats). warps 0: the general path, whose prep
// buffer is its whole scratch (no partials).
int make_plan(int m, int d, int n_e, Plan* p) {
  if (m <= 0 || d <= 0 || n_e <= 0) return 0;
  p->warps = d <= VQ_MAX_DIM ? warps_for(d, n_e) : 0;
  p->part_width = round4(n_e * d + n_e + 1);  // sum_z | counts | diff | 0 pad
  if (p->warps == 0) {
    const size_t floats = general_plan(m, d, n_e).floats;
    if (floats > 0x7fffffff) return 0;
    p->rows_per_block = 0;
    p->blocks = 0;
    p->prep_floats = static_cast<int>(floats);
    return 1;
  }
  const int per_block = 2 * p->warps;  // a pair of rows a warp at a time
  const int pairs = (m + per_block * VQ_TARGET_BLOCKS - 1) / (per_block * VQ_TARGET_BLOCKS);
  p->rows_per_block = per_block * pairs;
  p->blocks = (m + p->rows_per_block - 1) / p->rows_per_block;
  p->prep_floats = round4(n_e * d) + round4(d) + round4(n_e);
  return 1;
}

// kappa of the screen (module comment): twice the bound on |cross' - cross|
// over ||x|| ||y|| at width d
float screen_kappa(int d) {
  const double u = 0x1p-24, grow = 1.0 + 0x1p-9;
  const double k0 = 0x1p-20 + grow * (0x1p-16 + ((d + 31) / 32) * u) + d * u;
  return static_cast<float>(2.0 * k0 * (1.0 + 0x1p-20));
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

// c (the codebook's mean, summed in code order: the old kernel's bits) into
// cen (cenlen floats, 0 past d); a thread a column, 32 codes' loads at once
__global__ void __launch_bounds__(256)
vq_centre_kernel(const float* __restrict__ e, float* __restrict__ cen, int d, int n_e,
                 int cenlen) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cenlen) return;
  if (c >= d) {
    cen[c] = 0.0f;
    return;
  }
  float s = 0.0f;
  int k = 0;
  for (; k + 32 <= n_e; k += 32) {
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) v[u] = __ldg(e + (size_t)(k + u) * d + c);
#pragma unroll
    for (int u = 0; u < 32; ++u) s += v[u];
  }
  for (; k < n_e; ++k) s += __ldg(e + (size_t)k * d + c);
  cen[c] = s / n_e;
}

// ec = e - c at a stride of ldk (0 past d and past n_e) and q = ||ec||^2
// (lane-strided fmaf, then the butterfly: the old kernel's bits); a warp a
// code of n_pad
__global__ void __launch_bounds__(256)
vq_ec_kernel(const float* __restrict__ e, const float* __restrict__ cen, float* __restrict__ ec,
             float* __restrict__ esq, int d, int n_e, int n_pad, int ldk) {
  const int k = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (k >= n_pad) return;
  float s = 0.0f;
  for (int c = lane; c < ldk; c += 32) {
    const float t = k < n_e && c < d ? __fsub_rn(e[(size_t)k * d + c], cen[c]) : 0.0f;
    ec[(size_t)k * ldk + c] = t;
    if (c < d) s = fmaf(t, t, s);
  }
  s = warp_sum(s);
  if (lane == 0) esq[k] = s;
}

// z (m, d) at a stride of ldk, 0 past d: the GEMM's rows are 16-byte strided
__global__ void __launch_bounds__(256)
vq_pad_rows_kernel(const float* __restrict__ z, float* __restrict__ zp, int m, int d, int ldk) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)m * ldk) return;
  const int r = static_cast<int>(i / ldk), c = static_cast<int>(i % ldk);
  zp[i] = c < d ? z[(size_t)r * d + c] : 0.0f;
}

// sum over c < d, in column order, of fmaf(x_c, y_c, .) from 0, x_c = z_c -
// cen_c, y_c = y[c] (or x_c where y is null): the old kernel's s and cross
__device__ __forceinline__ float exact_sum(const float* zr, const float* cs,
                                          const float* __restrict__ y, int d, bool vec4) {
  float acc = 0.0f;
  int c = 0;
  if (vec4) {
    for (; c + 4 * GP_BATCH <= d; c += 4 * GP_BATCH) {  // the chunks' loads first
      float4 yv[GP_BATCH];
      if (y != nullptr)
#pragma unroll
        for (int b = 0; b < GP_BATCH; ++b) yv[b] = __ldg(reinterpret_cast<const float4*>(y + c) + b);
#pragma unroll
      for (int b = 0; b < GP_BATCH; ++b) {
        const float4 zv = *reinterpret_cast<const float4*>(zr + c + 4 * b);
        const float4 cv = *reinterpret_cast<const float4*>(cs + c + 4 * b);
        const float x[4] = {__fsub_rn(zv.x, cv.x), __fsub_rn(zv.y, cv.y), __fsub_rn(zv.z, cv.z),
                            __fsub_rn(zv.w, cv.w)};
        const float w[4] = {y != nullptr ? yv[b].x : x[0], y != nullptr ? yv[b].y : x[1],
                            y != nullptr ? yv[b].z : x[2], y != nullptr ? yv[b].w : x[3]};
#pragma unroll
        for (int j = 0; j < 4; ++j) acc = fmaf(x[j], w[j], acc);
      }
    }
    for (; c + 4 <= d; c += 4) {
      const float4 zv = *reinterpret_cast<const float4*>(zr + c);
      const float4 cv = *reinterpret_cast<const float4*>(cs + c);
      const float x[4] = {__fsub_rn(zv.x, cv.x), __fsub_rn(zv.y, cv.y), __fsub_rn(zv.z, cv.z),
                          __fsub_rn(zv.w, cv.w)};
      float w[4] = {x[0], x[1], x[2], x[3]};
      if (y != nullptr) {
        const float4 yv = __ldg(reinterpret_cast<const float4*>(y + c));
        w[0] = yv.x, w[1] = yv.y, w[2] = yv.z, w[3] = yv.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc = fmaf(x[j], w[j], acc);
    }
  }
  for (; c < d; ++c) {
    const float x = __fsub_rn(zr[c], cs[c]);
    acc = fmaf(x, y != nullptr ? __ldg(y + c) : x, acc);
  }
  return acc;
}

struct PickArgs {
  const float* z;         // (m, d)
  const float* codebook;  // (n_e, d)
  const float* ec;        // (n_pad, ldk)
  const float* cen;       // (cenlen,)
  const float* esq;       // (n_pad,)
  const float* cross;     // the chunk's products, (r1 - r0, n_pad)
  int64_t* idx;
  float* zq;
  float* rowdiff;
  int* hist;              // the grouping's unit counts (vq_group.cuh)
  int* rechecked;         // null, or each row's codes rechecked exactly (n_e: every code)
  int d, n_e, n_pad, ldk, ldz, R, staged, r0, r1;
  float kappa;
  kvq::VqGroup G;
};

__device__ __forceinline__ float screen_margin(float nx, float ny, float kappa) {
  const float s = nx + ny;
  return fmaf(2.0f * kappa * nx, ny, 0x1p-21f * s * s);
}

// Rows [r0 + R b, +R) of the chunk [r0, r1): the screen, the exact recheck,
// the first minimum, then z_q, the row's (z_q - z)^2 and its count (module
// comment). VEC: z, the codebook and zq 16-byte aligned and d % 4 == 0.
template <bool VEC>
__global__ void __launch_bounds__(GP_THREADS, 4) vq_pick_kernel(const PickArgs a) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red_d[GP_THREADS / 32];
  __shared__ int red_k[GP_THREADS / 32];
  const int R = a.R, d = a.d, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool staged = a.staged != 0, vec4 = staged || VEC;
  float* zs = sm;                                          // R x ldz: the rows of z
  float* cs_s = sm + (staged ? (size_t)R * a.ldz : 0);     // ldk: the centre
  float* sa = cs_s + (staged ? a.ldk : 0);                 // R: s
  int* cnt = reinterpret_cast<int*>(sa + R);               // R: codes kept (-1: every code)
  int* kpick = cnt + R;                                    // R
  int* off = kpick + R;                                    // R + 4: the rows' first task
  int* kept = off + R + 4;                                 // R x GP_CAP
  float* kval = reinterpret_cast<float*>(kept + R * GP_CAP);  // R x GP_CAP: their cross
  const float* cs = staged ? cs_s : a.cen;
  const int row0 = a.r0 + blockIdx.x * R, rows = min(R, a.r1 - row0);
  auto zrow = [&](int r) -> const float* {
    return staged ? zs + (size_t)r * a.ldz : a.z + (size_t)(row0 + r) * d;
  };

  if (staged) {
    for (int i = tid; i < a.ldk; i += GP_THREADS) cs_s[i] = a.cen[i];
    if (VEC) {
      const int c4 = d / 4;
      for (int i = tid; i < rows * c4; i += GP_THREADS) {
        const int r = i / c4, c = 4 * (i % c4);
        float4 v;
        asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
            : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
            : "l"(a.z + (size_t)(row0 + r) * d + c));
        *reinterpret_cast<float4*>(zs + (size_t)r * a.ldz + c) = v;
      }
    } else {
      for (int i = tid; i < rows * a.ldk; i += GP_THREADS) {
        const int r = i / a.ldk, c = i % a.ldk;
        zs[(size_t)r * a.ldz + c] = c < d ? a.z[(size_t)(row0 + r) * d + c] : 0.0f;
      }
    }
  }
  __syncthreads();

  // the screen, a warp a row; its rows' products on their way to L2 first
  for (int r = warp; r < rows; r += GP_THREADS / 32)
    for (int k = 32 * lane; k < a.n_e; k += 32 * 32)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(a.cross + (size_t)(row0 + r - a.r0) * a.n_pad + k));
  for (int r = warp; r < rows; r += GP_THREADS / 32) {
    const float* zr = zrow(r);
    float ss = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float x = __fsub_rn(zr[c], cs[c]);
      ss = fmaf(x, x, ss);
    }
    const float nx = sqrtf(warp_sum(ss));
    const float* crow = a.cross + (size_t)(row0 + r - a.r0) * a.n_pad;
    // t' and M of GP_BATCH codes a lane (k0 + lane + 32 b), their loads first
    auto screen_batch = [&](int k0, float (&t)[GP_BATCH], float (&mg)[GP_BATCH]) {
      float cr[GP_BATCH], q[GP_BATCH];
#pragma unroll
      for (int b = 0; b < GP_BATCH; ++b) {
        const int k = k0 + lane + 32 * b;
        cr[b] = k < a.n_e ? crow[k] : 0.0f;
        q[b] = k < a.n_e ? __ldg(a.esq + k) : 0.0f;
      }
#pragma unroll
      for (int b = 0; b < GP_BATCH; ++b) {
        t[b] = __fsub_rn(q[b], 2.0f * cr[b]);
        mg[b] = screen_margin(nx, sqrtf(q[b]), a.kappa);
      }
    };
    float U = __int_as_float(0x7f800000);
    bool finite = true;
    float t0[GP_BATCH], mg0[GP_BATCH];  // the first batch, kept for the second pass
    for (int k0 = 0; k0 < a.n_e; k0 += 32 * GP_BATCH) {
      float t[GP_BATCH], mg[GP_BATCH];
      screen_batch(k0, t, mg);
      if (k0 == 0)
#pragma unroll
        for (int b = 0; b < GP_BATCH; ++b) t0[b] = t[b], mg0[b] = mg[b];
#pragma unroll
      for (int b = 0; b < GP_BATCH; ++b) {
        if (k0 + lane + 32 * b >= a.n_e) continue;
        const float up = __fadd_ru(t[b], mg[b]);
        finite = finite && isfinite(up);
        U = fminf(U, up);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) U = fminf(U, __shfl_xor_sync(0xffffffffu, U, o));
    bool every = !__all_sync(0xffffffffu, finite) || !isfinite(U);
    int count = 0;
    if (!every) {
      for (int k0 = 0; k0 < a.n_e; k0 += 32 * GP_BATCH) {
        float t[GP_BATCH], mg[GP_BATCH];
        if (k0 == 0) {
#pragma unroll
          for (int b = 0; b < GP_BATCH; ++b) t[b] = t0[b], mg[b] = mg0[b];
        } else {
          screen_batch(k0, t, mg);
        }
#pragma unroll
        for (int b = 0; b < GP_BATCH; ++b) {  // codes in order: b, then the lanes
          const int k = k0 + lane + 32 * b;
          const bool hit = k < a.n_e && __fsub_rd(t[b], mg[b]) <= U;
          const unsigned bits = __ballot_sync(0xffffffffu, hit);
          const int at = count + __popc(bits & ((1u << lane) - 1u));
          if (hit && at < GP_CAP) kept[r * GP_CAP + at] = k;
          count += __popc(bits);
        }
      }
      every = count > GP_CAP;
    }
    if (lane == 0) cnt[r] = every ? -1 : count;
  }
  __syncthreads();

  // the exact sums: a row's s, then its kept codes' cross, a thread each
  if (tid == 0) {
    int o = 0;
    for (int r = 0; r < rows; ++r) off[r] = o, o += 1 + max(cnt[r], 0);
    off[rows] = o;
  }
  __syncthreads();
  for (int task = tid; task < off[rows]; task += GP_THREADS) {
    int r = 0;
    while (off[r + 1] <= task) ++r;
    const int j = task - off[r];
    if (j == 0)
      sa[r] = exact_sum(zrow(r), cs, nullptr, d, vec4);
    else
      kval[r * GP_CAP + j - 1] =
          exact_sum(zrow(r), cs, a.ec + (size_t)kept[r * GP_CAP + j - 1] * a.ldk, d, vec4);
  }
  __syncthreads();

  // the first minimum of s + q - 2 cross (strict <, codes in order)
  if (tid < rows && cnt[tid] >= 0) {
    float best = __int_as_float(0x7f800000);
    int bk = 0;
    for (int j = 0; j < cnt[tid]; ++j) {
      const int k = kept[tid * GP_CAP + j];
      const float dist = sa[tid] + __ldg(a.esq + k) - 2.0f * kval[tid * GP_CAP + j];
      if (dist < best) best = dist, bk = k;
    }
    kpick[tid] = bk;
  }
  for (int r = 0; r < rows; ++r) {  // a row that rechecks every code: the block's threads
    if (cnt[r] >= 0) continue;
    float best = __int_as_float(0x7f800000);
    int bk = 0;
    for (int k = tid; k < a.n_e; k += GP_THREADS) {
      const float dist = sa[r] + __ldg(a.esq + k) -
                         2.0f * exact_sum(zrow(r), cs, a.ec + (size_t)k * a.ldk, d, vec4);
      if (dist < best) best = dist, bk = k;
    }
    // the smaller distance, on equal distances the lower code
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best, o);
      const int ok = __shfl_xor_sync(0xffffffffu, bk, o);
      if (od < best || (od == best && ok < bk)) best = od, bk = ok;
    }
    if (lane == 0) red_d[warp] = best, red_k[warp] = bk;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < GP_THREADS / 32; ++w)
        if (red_d[w] < best || (red_d[w] == best && red_k[w] < bk)) best = red_d[w], bk = red_k[w];
      kpick[r] = bk;
    }
    __syncthreads();
  }
  __syncthreads();

  // z_q = z + (e[k] - z) (16-byte stores on VEC), the row's sum of (z_q -
  // z)^2 (lanes over columns c = lane + 32 j in order, the butterfly) and
  // the row's count
  for (int r = warp; r < rows; r += GP_THREADS / 32) {
    const int row = row0 + r, k = kpick[r];
    const float* zr = zrow(r);
    const float* q = a.codebook + (size_t)k * d;
    if (VEC) {
      for (int c0 = 4 * lane; c0 < d; c0 += 128 * GP_OUT) {  // GP_OUT chunks' loads at once
        float4 qv[GP_OUT];
#pragma unroll
        for (int b = 0; b < GP_OUT; ++b)
          if (c0 + 128 * b < d) qv[b] = __ldg(reinterpret_cast<const float4*>(q + c0 + 128 * b));
#pragma unroll
        for (int b = 0; b < GP_OUT; ++b) {
          const int c = c0 + 128 * b;
          if (c >= d) break;
          const float4 zv = *reinterpret_cast<const float4*>(zr + c);
          *reinterpret_cast<float4*>(a.zq + (size_t)row * d + c) =
              make_float4(zv.x + (qv[b].x - zv.x), zv.y + (qv[b].y - zv.y),
                          zv.z + (qv[b].z - zv.z), zv.w + (qv[b].w - zv.w));
        }
      }
    }
    float df = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float zz = zr[c], ea = __ldg(q + c) - zz;
      if (!VEC) a.zq[(size_t)row * d + c] = zz + ea;
      df = fmaf(ea, ea, df);
    }
    df = warp_sum(df);
    if (lane == 0) {
      a.idx[row] = k;
      a.rowdiff[row] = df;
      atomicAdd(a.hist + (size_t)a.G.unit_of(row) * a.n_e + k, 1);
      if (a.rechecked != nullptr) a.rechecked[row] = cnt[r] < 0 ? a.n_e : cnt[r];
    }
  }
}

template <bool VEC>
cudaError_t launch_pick(const PickArgs& args, int blocks, size_t smem, cudaStream_t st) {
  auto* kernel = vq_pick_kernel<VEC>;
  static unsigned configured = 0;  // a bit per device whose limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(configured >> dev & 1u)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GP_SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 32) configured |= 1u << dev;
  }
  kernel<<<blocks, GP_THREADS, smem, st>>>(args);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

// group: null, or kvq_vq_group_ints ints that receive the grouping in
// place of the scratch (for the codebook gradient); cross_out: null, or (m,
// n_pad) floats that receive the products in place of the scratch;
// rechecked: null, or (m,) ints (PickArgs)
cudaError_t vq_general(const Plan& p, cudaStream_t st, const float* z, const float* codebook,
                       float* zq, int64_t* idx, float* ws, float* stats, int* group, int m, int d,
                       int n_e, float* cross_out, int* rechecked) {
  const General P = general_plan(m, d, n_e);
  if (!P.zpad && !aligned16(z)) return cudaErrorInvalidValue;  // the GEMM's rows
  const bool vec_sums = d % 4 == 0 && aligned16(z);
  const kvq::VqGroup G = kvq::vq_group_plan(m, d, n_e, vec_sums);
  int* gws = group != nullptr ? group : reinterpret_cast<int*>(ws + P.group);
  float* cen = ws + P.cen;
  float* ec = ws + P.ec;
  float* esq = ws + P.esq;
  vq_centre_kernel<<<(P.cenlen + 255) / 256, 256, 0, st>>>(codebook, cen, d, n_e, P.cenlen);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  vq_ec_kernel<<<(P.n_pad + 7) / 8, 256, 0, st>>>(codebook, cen, ec, esq, d, n_e, P.n_pad, P.ldk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const float* za = z;
  int lda = d;
  if (P.zpad) {
    float* zp = ws + P.zp;
    const size_t n = (size_t)m * P.ldk;
    vq_pad_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(z, zp, m, d, P.ldk);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    za = zp, lda = P.ldk;
  }
  if ((e = cudaMemsetAsync(gws + G.hist, 0, (size_t)G.units * n_e * sizeof(int), st)) !=
      cudaSuccess)
    return e;
  PickArgs args{z, codebook, ec, cen, esq, nullptr, idx, zq, ws + P.rowdiff, gws + G.hist,
                rechecked, d, n_e, P.n_pad, P.ldk, P.ldz, P.R, P.staged ? 1 : 0, 0, 0,
                screen_kappa(d), G};
  const bool vec = d % 4 == 0 && aligned16(z) && aligned16(codebook) && aligned16(zq);
  const size_t smem = pick_words(P.R, P.staged, P.ldz, P.ldk) * sizeof(float);
  for (int r0 = 0; r0 < m; r0 += P.chunk) {
    const int rows = m - r0 < P.chunk ? m - r0 : P.chunk;
    float* cross = cross_out != nullptr ? cross_out + (size_t)r0 * P.n_pad : ws + P.cross;
    e = static_cast<cudaError_t>(kvq::f32gemm::run_vq_cross(
        za + (size_t)r0 * lda, lda, cen, ec, P.ldk, rows, P.n_pad, d, cross, st));
    if (e != cudaSuccess) return e;
    args.cross = cross, args.r0 = r0, args.r1 = r0 + rows;
    const int blocks = (rows + P.R - 1) / P.R;
    e = vec ? launch_pick<true>(args, blocks, smem, st) : launch_pick<false>(args, blocks, smem, st);
    if (e != cudaSuccess) return e;
  }
  return kvq::vq_grouped_sum(G, true, z, idx, nullptr, nullptr, ws + P.rowdiff, gws, stats,
                             p.part_width, true, false, vec_sums, st);
}


}  // namespace

extern "C" {

// plan (5 ints): warps a block (0: the general path), rows a block, blocks
// (partials; 0 on the general path), the width of a partial and of the
// stats (floats), the prep buffer's floats (on the general path its whole
// scratch). Returns 0, or cudaErrorInvalidValue for an empty shape.
int kvq_vq_plan(int m, int d, int n_e, int* plan) {
  Plan p;
  if (!make_plan(m, d, n_e, &p)) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.warps, plan[1] = p.rows_per_block, plan[2] = p.blocks, plan[3] = p.part_width;
  plan[4] = p.prep_floats;
  return 0;
}

// The screen's kappa at width d (vq_fwd.cu's module comment)
float kvq_vq_screen_kappa(int d) { return screen_kappa(d); }

// The general path as kvq_vq_fwd, and what its screen saw: cross (m,
// round4(n_e)) f32 receives the tensor-core products (z - c) . (e_k - c),
// rechecked (m,) int32 the codes each row summed exactly (n_e: every code).
// cudaErrorInvalidValue where the shape takes the one-pass kernel.
int kvq_vq_fwd_screen(const float* z, const float* codebook, float* zq, int64_t* idx, float* ws,
                      float* stats, float* cross, int* rechecked, int m, int d, int n_e,
                      void* stream) {
  Plan p;
  if (!make_plan(m, d, n_e, &p) || p.warps != 0 || !aligned16(ws) || cross == nullptr ||
      rechecked == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(vq_general(p, static_cast<cudaStream_t>(stream), z, codebook, zq, idx,
                                     ws, stats, nullptr, m, d, n_e, cross, rechecked));
}

// z (m, d) f32, codebook (n_e, d) f32 -> zq (m, d) f32, the straight-through
// value z + (codebook[idx] - z); idx (m,) int64; stats (part_width,) f32:
// sum_z (n_e, d) | counts (n_e) | diff (1) | 0 pad. ws: prep_floats +
// blocks * part_width floats of scratch, 16-byte aligned. group: null, or
// on the general path kvq_vq_group_ints ints that receive the rows'
// grouping by code (for kvq_vq_codebook_grad).
int kvq_vq_fwd(const float* z, const float* codebook, float* zq, int64_t* idx, float* ws,
               float* stats, int* group, int m, int d, int n_e, void* stream) {
  Plan p;
  if (!make_plan(m, d, n_e, &p) || !aligned16(ws)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.warps == 0)
    return static_cast<int>(
        vq_general(p, st, z, codebook, zq, idx, ws, stats, group, m, d, n_e, nullptr, nullptr));
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
