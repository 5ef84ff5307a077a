// The layer GEMM in f32 for Hopper (sm_90a): C = epi(op(A) @ op(B)) on f32
// operands, the f32 instance of gemm_sm90.cuh.
//
// Replaces, in f32 (JAX's parity dtype, `compute_dtype="float32"`), the
// products of kindergarten_vq_vae_tpu/ops/layer_pallas.py `_layer_fwd_kernel`
// (l.489: `_mm` with the bias and the GELU of `_gelu_fwd`) and
// `_layer_bwd_kernel` (l.552: `_mm_nt` with the residual add or the GELU
// gradient of `_gelu_grad`, and `_mm_tn` for the weight gradients), which run
// in the run's compute dtype. Entry point kvq_gemm_f32 (ops/gemm.py `gemm`
// on f32 tensors); the layer forward (layer_fwd.cu) calls run_gemm.
//
// It also carries the f32 instance of the fused MLM head + CE
// (kindergarten_vq_vae_tpu/ops/head_ce_pallas.py `_fwd_kernel` l.67, #9, and
// `_bwd_kernel` l.179, #10, in f32, where their casts to x's dtype are
// identities): run_ce computes the NT product x @ E^T with a CE epilogue,
// l = acc + b in f32 (l.85), and head_ce.cu's f32 entries add the partials'
// merge, the store-mode gradient pass, dx = g @ E (NN, K = V) and the table
// gradient g^T @ x (TN split-K) on run_gemm.
//
// It also computes the VQ general path's distance products (vq_fwd.cu,
// run_vq_cross, EPI_VQ_CROSS): the NT product (z - c) @ (e - c)^T, each
// element of z centred by one f32 subtraction as the consumer reads it for
// its split, the products stored as with EPI_F32.
//
// Precision: f32 is the parity dtype, so single-pass TF32 (a 10-bit
// mantissa, ~5e-4 relative a product) is not enough. Each operand is split
// into a TF32 high part and the TF32 rounding of its remainder, x = big +
// small to ~22 bits (cvt.rna both), and each 32-deep slice of K sums
// small*big + big*small + big*big of its four 8-deep steps in a fresh
// accumulator that one rounded FADD adds to the tile's f32 sum (3xTF32):
// within a few 1e-7 of an f32 product, the small*small term (2^-22)
// dropped. The tensor cores' own accumulation does not round to nearest,
// and a chain of it over a long K drifts (PERF.md, the f32 GEMM's
// precision): hence the fresh accumulator of every slice. Measured on an
// H100 against f32 products, promoting once a slice holds the f32 bars at
// K = 3,072 and over the weight and table gradients' 24,576 rows (PERF.md,
// the f32 GEMM).
//
// What bounds it on the H100: operations. At the step's 24,576 rows a
// product of K = 768 or 3,072 does ~100 FLOP a byte in f32; 3xTF32 runs
// three TF32 products (494.7 TFLOP/s dense) for one f32 one, a bound of 165
// TFLOP/s, which only wgmma reaches. wgmma's tf32 form takes B K-major from
// shared memory and A K-major from shared memory or from registers. The
// design:
// - one persistent CTA an SM walks 128 x 128 output tiles (groups of 16 row
//   tiles, so the CTAs in flight share their operands in L2) over 32-deep
//   slices of K;
// - a producer thread keeps TMA loads (cp.async.bulk.tensor, 128-byte
//   swizzle, 32 floats a row; rows and columns past the matrix zero-filled)
//   of A's and B's f32 tiles in flight into a ring of 4 stages, each with a
//   "full" and an "empty" mbarrier; its warpgroup gives its registers to
//   the consumers (setmaxnreg);
// - two consumer warpgroups (the tile's rows [0, 64) and [64, 128)) read
//   their 64 x 32 slice of A from the raw stage into registers (A stored
//   (m, k) or (k, m), the swizzle keeping the reads free of bank conflicts
//   or at two ways), split each element once, and issue the slice's
//   products as wgmma.m64n64k8.tf32 with A from registers, in two 64-wide
//   halves, each a commit group of 12 into a fresh accumulator. While those
//   run, each warpgroup splits half of the next slice's B tile (one row a
//   thread, 16 deep) into its big and small TF32 parts, K-major tiles with
//   the 128-byte swizzle (B stored (K, N), in NN and TN, is transposed on
//   the way), in a ring of 2 stages published through a proxy fence and an
//   mbarrier: B is split once per element. Then the FADDs, the first
//   half's while the second half's products run; the two warpgroups meet
//   only at the converted stages, so one's splits and adds overlap the
//   other's products;
// - the epilogue runs on the accumulator registers (thread (g, t) of warp w
//   holds rows 16 w + g and 16 w + g + 8 of its half, columns 8 j + 2 t and
//   8 j + 2 t + 1) while the producer fills the ring for the next tile (and
//   the last slice's products ran beside the next tile's first B split;
//   the residual or u it reads was pulled into L2 while the tile's
//   products ran, and is loaded, with the bias, before any arithmetic),
//   and writes f32 pairs: bias, GELU (with the pre-GELU u),
//   the residual add, the GELU gradient with du's column sums per 128-row
//   tile, or a split-K partial of a weight gradient, summed in a fixed
//   order by splitk_reduce_kernel. Every sum is the same bits in every run;
// - a column sum over a 128-row tile (du's for b1, dbias's in EPI_CE_BWD)
//   adds each thread's two rows in order, then the warp's eight row groups
//   by a butterfly over g, then the 8 consumer warps in order through
//   shared memory; head_ce.cu's store-mode pass repeats that order to the
//   bit. The CE epilogues (EPI_CE_FWD / EPI_CE_BWD, on the NT product with
//   the table as B, 128 x 128 tiles: HEAD_TILE_N) reduce each row of the
//   tile over the thread's 32 columns in increasing order, then over the
//   row's four lanes by butterflies: per (vocab tile, row) partials (max,
//   sum of exp, target logit, first argmax; head_ce.cu merges them in
//   vocab-tile order) and store mode's f32 logits, or g = (exp(l - lse) -
//   onehot) * scale with its dbias partials. Columns at or past V are -inf
//   logits and 0 gradients, written 0 up to the padded leading dimension; V
//   may be odd.
//
// Rows whose extent is not a multiple of 4 (the vocabulary's 30,522 as g's K
// in dx, or as the table gradient's M) lie inside a leading dimension of a
// multiple of 4 (TMA's 16-byte strides); the tensor maps end at the extent,
// so TMA zero-fills what lies past it.

#include <climits>
#include <cstdint>

#include "gemm_f32.cuh"
#include "layer_common.cuh"
#include "layernorm.cuh"
#include "sm90_ptx.cuh"

namespace kvq {
namespace f32gemm {

namespace {

using sm90::fence_proxy_async;
using sm90::fence_reg;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::setmaxnreg_dec;
using sm90::setmaxnreg_inc;
using sm90::smem_u32;
using sm90::sw128_desc;
using sm90::tma_load;
using sm90::tma_prefetch;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int CONSUMERS = 256;              // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;    // and the producer's warpgroup
constexpr int RAW_STAGES = 4, CVT_STAGES = 2;
constexpr int TILE_FLOATS = TILE_M * TILE_K;  // one operand's 128 x 32 tile
constexpr int TILE_BYTES = TILE_FLOATS * 4;
constexpr int BOX = 32;                       // an MN-major operand's tile: 4 boxes of 32 x 32
constexpr int BOX_FLOATS = BOX * TILE_K;
constexpr int STAGE_BYTES = 2 * TILE_BYTES;   // raw: A, B; converted: B big, B small
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int RED_BYTES = CONSUMER_WARPS * TILE_N * 4;
constexpr int BAR_BYTES = 128;
// the ring, the column sums' staging, the barriers, the 1024-byte alignment
// of the swizzled tiles
constexpr int SMEM_BYTES =
    (RAW_STAGES + CVT_STAGES) * STAGE_BYTES + RED_BYTES + BAR_BYTES + 1024;
static_assert(SMEM_BYTES <= 232448 && 2 * (RAW_STAGES + CVT_STAGES) * 8 <= BAR_BYTES, "smem");
constexpr int GROUP_M = 16;  // row tiles a group of the raster walks before its columns
// registers a thread holds after setmaxnreg: the producer's warpgroup gives
// its share to the consumers; the CTA's pool (384 threads of 168) covers
// them, which the host checks before a launch
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int POOL = 128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS;
static_assert(POOL <= 65536, "register pool");

struct Params {
  int M, N, K, kchunk;
  int tiles_m, tiles_n, units;  // units: tiles_m * tiles_n * splits
  float* C;                     // EPI_PARTIAL: the split-K workspace (splits, M, N)
  int ldc;
  float* C2;
  int ldc2;
  const float* aux;
  int ld_aux;
  const float* bias;
  float* colpart;  // (tiles_m, N): du's column sums of each 128-row tile
  // the CE epilogues: targets (M,); EPI_CE_BWD also lse and scale (M,);
  // part_f the (3, tiles_n, M) partials (EPI_CE_FWD, with part_i (tiles_n,
  // M)) or the (tiles_m, N) dbias partials (EPI_CE_BWD)
  const int* targets;
  const float* lse;
  const float* scale;
  float* part_f;
  int* part_i;
};

// d = a (64 x 8 tf32, registers: a0 (row g, column t), a1 (g + 8, t), a2
// (g, t + 4), a3 (g + 8, t + 4) of each warp's 16 rows) times b (8 x 64
// tf32, K-major, 128-byte swizzle, in shared memory), d not read
__device__ __forceinline__ void wgmma_tf32_first(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}

// d += a b, as wgmma_tf32_first
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One unit of work: split z's K range of output tile (mt, nt). Within a
// split, groups of GROUP_M row tiles are walked column tile by column tile.
struct Tile {
  int z, mt, nt, m0, n0, kbeg, kend;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int u) {
  const int per_split = p.tiles_m * p.tiles_n;
  const int z = u / per_split, r = u % per_split;
  const int group = GROUP_M * p.tiles_n, first = (r / group) * GROUP_M;
  const int rows = min(p.tiles_m - first, GROUP_M);
  const int mt = first + (r % group) % rows, nt = (r % group) / rows;
  const int kbeg = z * p.kchunk;
  return Tile{z, mt, nt, mt * TILE_M, nt * TILE_N, kbeg, min(p.K, kbeg + p.kchunk)};
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// A column sum over the tile's 128 rows in a fixed order (module comment):
// cs the thread's two rows, summed over g by a butterfly, parked per warp
// in red, then the 8 warps added in order into out[0, cols).
__device__ __forceinline__ void tile_column_sums(const float (&cs)[16][2], float* red, int g,
                                                 int t, int cw, int ct, float* out, int cols) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = cs[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[cw * TILE_N + 8 * j + 2 * t + e] = v;
    }
  consumers_sync();
  if (ct < TILE_N && ct < cols) {
    float tot = red[ct];
#pragma unroll
    for (int w = 1; w < CONSUMER_WARPS; ++w) tot += red[w * TILE_N + ct];
    out[ct] = tot;
  }
  consumers_sync();  // red is free for the next tile
}

// The CE forward epilogue (#9) on the NT product x @ E^T: l = acc + b (N the
// vocabulary; columns at or past it -inf), and each of the tile's rows
// reduced to its partial (module comment); store mode (C not null) also
// writes l at ldc, its pad columns 0.
__device__ __forceinline__ void ce_fwd_epilogue(const Params& p, const float (&acc)[64],
                                                const Tile& tl, int rl, int t) {
  float b[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = tl.n0 + 8 * j + 2 * t + e;
      b[j][e] = col < p.N ? p.bias[col] : 0.0f;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = tl.m0 + rl + 8 * h;
    const bool live = row < p.M;
    const int tgt = live ? p.targets[row] : -1;
    float l[16][2], mx = -INFINITY, tv = 0.0f;
    int first = INT_MAX;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // this thread's columns in increasing order
        const int col = tl.n0 + 8 * j + 2 * t + e;
        l[j][e] = col < p.N ? acc[4 * j + 2 * h + e] + b[j][e] : -INFINITY;
        if (l[j][e] > mx) mx = l[j][e], first = col;
        if (col == tgt && col < p.N) tv = l[j][e];
      }
    // the row's 128 columns: lanes t = 0..3
    float wmx = mx;
    wmx = fmaxf(wmx, __shfl_xor_sync(0xffffffffu, wmx, 1));
    wmx = fmaxf(wmx, __shfl_xor_sync(0xffffffffu, wmx, 2));
    int fi = mx == wmx ? first : INT_MAX;
    fi = min(fi, __shfl_xor_sync(0xffffffffu, fi, 1));
    fi = min(fi, __shfl_xor_sync(0xffffffffu, fi, 2));
    float s = 0.0f;
    if (wmx != -INFINITY)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) s += expf(l[j][e] - wmx);  // 0 at the -inf columns
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    tv += __shfl_xor_sync(0xffffffffu, tv, 1);  // one lane holds it, or none
    tv += __shfl_xor_sync(0xffffffffu, tv, 2);
    if (!live) continue;
    if (t == 0) {
      const size_t plane = (size_t)p.tiles_n * p.M, o = (size_t)tl.nt * p.M + row;
      p.part_f[o] = wmx;
      p.part_f[plane + o] = s;
      p.part_f[2 * plane + o] = tv;
      p.part_i[o] = fi;
    }
    if (p.C != nullptr)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = tl.n0 + 8 * j + 2 * t;
        if (col < p.ldc)  // ldc even: both columns inside; past N 0
          *reinterpret_cast<float2*>(p.C + (size_t)row * p.ldc + col) =
              make_float2(col < p.N ? l[j][0] : 0.0f, col + 1 < p.N ? l[j][1] : 0.0f);
      }
  }
}

// The CE backward epilogue (#10, flash mode): l recomputed as
// ce_fwd_epilogue computes it, g = (exp(l - lse) - onehot) * scale (0 at or
// past N) written at ldc with its pad columns 0, and the tile's dbias
// partial of each column in tile_column_sums' order (head_ce.cu
// `head_ce_grad_f32_kernel` sums in this order).
__device__ __forceinline__ void ce_bwd_epilogue(const Params& p, const float (&acc)[64],
                                                const Tile& tl, float* red, int rl, int g, int t,
                                                int cw, int ct) {
  float b[16][2], cs[16][2] = {};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = tl.n0 + 8 * j + 2 * t + e;
      b[j][e] = col < p.N ? p.bias[col] : 0.0f;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = tl.m0 + rl + 8 * h;
    if (row >= p.M) continue;
    const int tgt = p.targets[row];
    const float lse = p.lse[row], sc = p.scale[row];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = tl.n0 + 8 * j + 2 * t;
      float gm[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        gm[e] = col + e < p.N ? ce_grad(acc[4 * j + 2 * h + e] + b[j][e], lse, col + e == tgt, sc)
                              : 0.0f;
        cs[j][e] += gm[e];
      }
      if (col < p.ldc)
        *reinterpret_cast<float2*>(p.C + (size_t)row * p.ldc + col) = make_float2(gm[0], gm[1]);
    }
  }
  tile_column_sums(cs, red, g, t, cw, ct, p.part_f + (size_t)tl.mt * p.N + tl.n0,
                   min(TILE_N, p.N - tl.n0));
}

// The epilogues that read an f32 aux of the tile (the residual add, the
// GELU gradient's u)
template <int EPI>
constexpr bool READS_AUX = EPI == EPI_ADD_F32 || EPI == EPI_DGELU_ERF || EPI == EPI_DGELU_TANH;

// Pulls the tile's aux rows into L2 while its products run (two 128-byte
// lines a consumer thread), so that the epilogue's loads wait on L2.
template <int EPI>
__device__ __forceinline__ void prefetch_aux(const Params& p, const Tile& tl, int ct) {
  if constexpr (READS_AUX<EPI>) {
#pragma unroll
    for (int i = ct; i < TILE_M * 4; i += CONSUMERS) {  // 4 lines a row
      const int row = tl.m0 + i / 4, col = tl.n0 + 32 * (i % 4);
      if (row < p.M && col < p.N)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p.aux + (size_t)row * p.ld_aux + col));
    }
  }
}

// Every other epilogue, from the registers: the bias, GELU (with u in C2),
// the residual add, the GELU gradient (du in C and C2, its column partials),
// or a split-K partial. The aux pairs and the bias are read first, all at
// once.
template <int EPI>
__device__ __forceinline__ void store_epilogue(const Params& p, const float (&acc)[64],
                                               const Tile& tl, float* red, int rl, int g, int t,
                                               int cw, int ct) {
  constexpr bool DGELU = EPI == EPI_DGELU_ERF || EPI == EPI_DGELU_TANH;
  float* C = p.C + (EPI == EPI_PARTIAL ? (size_t)tl.z * p.M * p.N : 0);
  float2 aux[2][16], bias[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = tl.n0 + 8 * j + 2 * t;
    bias[j] = p.bias != nullptr && col < p.N ? make_float2(p.bias[col], p.bias[col + 1])
                                             : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tl.m0 + rl + 8 * h;
      aux[h][j] = make_float2(0.0f, 0.0f);
      if constexpr (READS_AUX<EPI>)
        if (row < p.M && col < p.N)
          aux[h][j] = *reinterpret_cast<const float2*>(p.aux + (size_t)row * p.ld_aux + col);
    }
  }
  float cs[16][2] = {};  // dgelu: du's sums over this thread's rows, by column
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = tl.m0 + rl + 8 * h;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = tl.n0 + 8 * j + 2 * t;
      if (col >= p.N) continue;  // N even: both columns or neither
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      float2* c = reinterpret_cast<float2*>(C + (size_t)row * p.ldc + col);
      if constexpr (EPI == EPI_F32 || EPI == EPI_PARTIAL || EPI == EPI_VQ_CROSS) {
        if (p.bias != nullptr) v0 += bias[j].x, v1 += bias[j].y;
        *c = make_float2(v0, v1);
      } else if constexpr (EPI == EPI_GELU_ERF || EPI == EPI_GELU_TANH) {
        if (p.bias != nullptr) v0 += bias[j].x, v1 += bias[j].y;
        if (p.C2 != nullptr)
          *reinterpret_cast<float2*>(p.C2 + (size_t)row * p.ldc2 + col) = make_float2(v0, v1);
        *c = EPI == EPI_GELU_ERF ? make_float2(gelu_erf(v0), gelu_erf(v1))
                                 : make_float2(gelu_tanh(v0), gelu_tanh(v1));
      } else if constexpr (EPI == EPI_ADD_F32) {
        *c = make_float2(v0 + aux[h][j].x, v1 + aux[h][j].y);
      } else {
        static_assert(DGELU, "unknown epilogue");
        const float2 u = aux[h][j];
        v0 *= EPI == EPI_DGELU_ERF ? gelu_erf_grad(u.x) : gelu_tanh_grad(u.x);
        v1 *= EPI == EPI_DGELU_ERF ? gelu_erf_grad(u.y) : gelu_tanh_grad(u.y);
        *c = make_float2(v0, v1);
        if (p.C2 != nullptr)
          *reinterpret_cast<float2*>(p.C2 + (size_t)row * p.ldc2 + col) = make_float2(v0, v1);
        cs[j][0] += v0;
        cs[j][1] += v1;
      }
    }
  }
  if constexpr (DGELU)
    if (p.colpart != nullptr)
      tile_column_sums(cs, red, g, t, cw, ct, p.colpart + (size_t)tl.mt * p.N + tl.n0,
                       min(TILE_N, p.N - tl.n0));
}

// A: A_T false, (M, K) row-major, map (rows M, cols K), box 32 x 128: the
//    stage's tile is 128 rows (m) of 32 floats (k);
//    A_T true, stored (K, M), map (rows K, cols M), box 32 x 32: 4 boxes of
//    32 rows (k) of 32 floats (m), box i holding m in [32 i, 32 i + 32).
// B: B_T true, stored (N, K), map (rows N, cols K), box 32 x 128: 128 rows
//    (n) of 32 floats (k), already K-major;
//    B_T false, stored (K, N), map (rows K, cols N), box 32 x 32: 4 boxes.
// Every row is 128 bytes, its 16-byte chunks swizzled by the row's index
// modulo 8. Warps 0-7 are the two consumer warpgroups, thread 256 the
// producer. grid: min(units, SMs) persistent CTAs.
template <bool A_T, bool B_T, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_f32_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t cvt_off = RAW_STAGES * STAGE_BYTES;
  const uint32_t red_off = (RAW_STAGES + CVT_STAGES) * STAGE_BYTES;
  const uint32_t bar_base = base + red_off + RED_BYTES;
  float* const red = reinterpret_cast<float*>(gbase + red_off);
  auto raw_full = [&](int s) { return bar_base + 8u * s; };
  auto raw_empty = [&](int s) { return bar_base + 8u * (RAW_STAGES + s); };
  auto cvt_full = [&](int s) { return bar_base + 8u * (2 * RAW_STAGES + s); };
  auto cvt_empty = [&](int s) { return bar_base + 8u * (2 * RAW_STAGES + CVT_STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < RAW_STAGES; ++s) {
      mbar_init(raw_full(s), 1);           // the producer's arrive, with the bytes
      mbar_init(raw_empty(s), CONSUMERS);  // every consumer thread has read its part
    }
    for (int s = 0; s < CVT_STAGES; ++s) {
      mbar_init(cvt_full(s), CONSUMERS);   // every consumer thread has written its part
      mbar_init(cvt_empty(s), 2);          // each consumer warpgroup's products are done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ------------------------------------------------ producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS) return;
    tma_prefetch(&map_a);
    tma_prefetch(&map_b);
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Tile tl = tile_of(p, u);
      for (int k = tl.kbeg; k < tl.kend; k += TILE_K) {
        mbar_wait(raw_empty(stage), phase ^ 1);
        mbar_expect_tx(raw_full(stage), STAGE_BYTES);
        const uint32_t sa = base + stage * STAGE_BYTES, sb = sa + TILE_BYTES;
        if constexpr (A_T) {
#pragma unroll
          for (int i = 0; i < TILE_M / BOX; ++i)
            tma_load(sa + i * BOX_FLOATS * 4, &map_a, raw_full(stage), tl.m0 + BOX * i, k);
        } else {
          tma_load(sa, &map_a, raw_full(stage), k, tl.m0);
        }
        if constexpr (B_T) {
          tma_load(sb, &map_b, raw_full(stage), k, tl.n0);
        } else {
#pragma unroll
          for (int i = 0; i < TILE_N / BOX; ++i)
            tma_load(sb + i * BOX_FLOATS * 4, &map_b, raw_full(stage), tl.n0 + BOX * i, k);
        }
        if (++stage == RAW_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------- two consumer warpgroups
  setmaxnreg_inc<CONSUMER_REGS>();
  const int ct = threadIdx.x, cw = ct / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
  const int rl = 16 * cw + g;  // the tile rows rl and rl + 8 (warpgroup cw / 4's half)
  // the part of B's tiles this thread converts: row n, k in [4 c0, 4 c0 + 16)
  const int n = ct % TILE_N, c0 = 4 * (ct / TILE_N);
  int slices = 0;  // this CTA's slices, over all its units
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Tile tl = tile_of(p, u);
    slices += (tl.kend - tl.kbeg + TILE_K - 1) / TILE_K;
  }

  // Slice i's B: its big and small parts, K-major with the raw tile's
  // swizzle, into converted stage i % CVT_STAGES once both warpgroups'
  // products of slice i - CVT_STAGES have left it.
  auto convert = [&](int i) {
    const int rs = i % RAW_STAGES, cs = i % CVT_STAGES;
    mbar_wait(raw_full(rs), (i / RAW_STAGES) & 1);
    mbar_wait(cvt_empty(cs), ((i / CVT_STAGES) & 1) ^ 1);
    const float* rb = reinterpret_cast<const float*>(gbase + rs * STAGE_BYTES + TILE_BYTES);
    uint32_t* big = reinterpret_cast<uint32_t*>(gbase + cvt_off + cs * STAGE_BYTES);
    uint32_t* small = big + TILE_FLOATS;
#pragma unroll
    for (int c = c0; c < c0 + 4; ++c) {  // 16-byte chunks: k in [4 c, 4 c + 4)
      float v[4];
      if constexpr (B_T) {
        const float4 x = *reinterpret_cast<const float4*>(rb + n * TILE_K + ((c ^ (n & 7)) << 2));
        v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 4 * c + e;
          v[e] = rb[(n / BOX) * BOX_FLOATS + kk * BOX + ((((n % BOX) >> 2) ^ (kk & 7)) << 2) +
                    (n & 3)];
        }
      }
      uint4 hb, hs;
      split_tf32(v[0], hb.x, hs.x);
      split_tf32(v[1], hb.y, hs.y);
      split_tf32(v[2], hb.z, hs.z);
      split_tf32(v[3], hb.w, hs.w);
      const int o = n * TILE_K + ((c ^ (n & 7)) << 2);
      *reinterpret_cast<uint4*>(big + o) = hb;
      *reinterpret_cast<uint4*>(small + o) = hs;
    }
    fence_proxy_async();  // the tiles are read by wgmma
    mbar_arrive(cvt_full(cs));
  };

  if (slices > 0) convert(0);
  int i = 0;  // the slice, counted over the CTA's units
  float acc[64];
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Tile tl = tile_of(p, u);
    prefetch_aux<EPI>(p, tl, ct);
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[q] = 0.0f;
    for (int k = tl.kbeg; k < tl.kend; k += TILE_K, ++i) {
      const int rs = i % RAW_STAGES, cs = i % CVT_STAGES;
      // this thread's A: rows rl, rl + 8, k = t + 4 j (j < 8); 8-deep step s
      // takes k = 8 s + t (a0, a1) and 8 s + t + 4 (a2, a3)
      mbar_wait(raw_full(rs), (i / RAW_STAGES) & 1);
      const float* ra = reinterpret_cast<const float*>(gbase + rs * STAGE_BYTES);
      float va[2][8], cen[8];
      if constexpr (EPI == EPI_VQ_CROSS)  // the centre of this thread's k (0 past K)
#pragma unroll
        for (int j = 0; j < 8; ++j) cen[j] = __ldg(p.aux + k + t + 4 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int m = rl + 8 * h, kk = t + 4 * j;
          va[h][j] = A_T ? ra[(m / BOX) * BOX_FLOATS + kk * BOX +
                              ((((m % BOX) >> 2) ^ (kk & 7)) << 2) + (m & 3)]
                         : ra[m * TILE_K + ((j ^ g) << 2) + t];  // m % 8 = g
          if constexpr (EPI == EPI_VQ_CROSS) va[h][j] = __fsub_rn(va[h][j], cen[j]);
        }
      mbar_arrive(raw_empty(rs));  // its B part was read by convert(i)
      uint32_t ab[4][4], as[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        split_tf32(va[0][2 * s], ab[s][0], as[s][0]);
        split_tf32(va[1][2 * s], ab[s][1], as[s][1]);
        split_tf32(va[0][2 * s + 1], ab[s][2], as[s][2]);
        split_tf32(va[1][2 * s + 1], ab[s][3], as[s][3]);
      }
      mbar_wait(cvt_full(cs), (i / CVT_STAGES) & 1);
      // the slice's products in two 64-wide halves (B's rows 0-63 and
      // 64-127: 8 KB apart), each in a fresh accumulator, the steps' small
      // terms first; 8 deeper: 32 bytes along each K-major row
      const uint32_t sbig = base + cvt_off + cs * STAGE_BYTES, ssmall = sbig + TILE_BYTES;
      float d0[32], d1[32];
      auto products = [&](float(&d)[32], int half) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint64_t db = sw128_desc(sbig + 8192 * half + 32 * s, 16, 1024);
          const uint64_t ds = sw128_desc(ssmall + 8192 * half + 32 * s, 16, 1024);
          if (s == 0)
            wgmma_tf32_first(d, as[s], db);
          else
            wgmma_tf32(d, as[s], db);
          wgmma_tf32(d, ab[s], ds);
          wgmma_tf32(d, ab[s], db);
        }
        wgmma_commit();
      };
      wgmma_fence();
      products(d0, 0);
      products(d1, 1);
      // the next slice's B while the tensor cores run
      if (i + 1 < slices) convert(i + 1);
      // then the adds: the first half's while the second half's products run
      wgmma_wait<1>();
#pragma unroll
      for (int q = 0; q < 32; ++q) fence_reg(d0[q]);
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[q] += d0[q];
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < 32; ++q) fence_reg(d1[q]);
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[32 + q] += d1[q];
      // the products read ab and as until here
#pragma unroll
      for (int s = 0; s < 4; ++s)
        asm volatile("" ::"r"(ab[s][0]), "r"(ab[s][1]), "r"(ab[s][2]), "r"(ab[s][3]),
                     "r"(as[s][0]), "r"(as[s][1]), "r"(as[s][2]), "r"(as[s][3]));
      if (ct % 128 == 0) mbar_arrive(cvt_empty(cs));
    }
    if constexpr (EPI == EPI_CE_FWD)
      ce_fwd_epilogue(p, acc, tl, rl, t);
    else if constexpr (EPI == EPI_CE_BWD)
      ce_bwd_epilogue(p, acc, tl, red, rl, g, t, cw, ct);
    else
      store_epilogue<EPI>(p, acc, tl, red, rl, g, t, cw, ct);
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

template <bool A_T, bool B_T, int EPI>
cudaError_t launch(Params p, const float* A, int lda, const float* B, int ldb, int splits,
                   cudaStream_t st) {
  auto* kernel = gemm_f32_kernel<A_T, B_T, EPI>;
  static unsigned configured = 0;  // a bit per device whose shared-memory limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(configured >> dev & 1u)) {
    // setmaxnreg.inc waits for registers the CTA does not have: never launch so
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    if (attr.numRegs * THREADS < POOL) return cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return e;
    if (dev < 32) configured |= 1u << dev;
  }
  CUtensorMap ma, mb;
  const bool maps = (A_T ? sm90::tensor_map_f32(&ma, A, p.K, p.M, lda, BOX, BOX)
                         : sm90::tensor_map_f32(&ma, A, p.M, p.K, lda, TILE_K, TILE_M)) &&
                    (B_T ? sm90::tensor_map_f32(&mb, B, p.N, p.K, ldb, TILE_K, TILE_N)
                         : sm90::tensor_map_f32(&mb, B, p.K, p.N, ldb, BOX, BOX));
  const int sms = sm_count();
  if (!maps || sms <= 0) return cudaErrorInvalidValue;
  p.tiles_m = (p.M + TILE_M - 1) / TILE_M;
  p.tiles_n = (p.N + TILE_N - 1) / TILE_N;
  p.units = p.tiles_m * p.tiles_n * splits;
  kernel<<<p.units < sms ? p.units : sms, THREADS, SMEM_BYTES, st>>>(ma, mb, p);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

int round4(int n) { return (n + 3) / 4 * 4; }

}  // namespace

int run_gemm(int a_t, int b_t, const float* A, int lda, const float* B, int ldb, int M, int N,
             int K, int epi, int splits, int kchunk, float* C, int ldc, float* C2, int ldc2,
             const float* aux, int ld_aux, const float* bias, float* ws, float* colparts,
             float* colsum, cudaStream_t st) {
  // every row lies inside its leading dimension, on to the next multiple of
  // 4 (TMA's 16-byte strides; module comment)
  const int a_row = a_t ? M : K, b_row = b_t ? K : N;
  const bool shape_ok = M > 0 && N > 0 && K > 0 && round4(a_row) <= lda && round4(b_row) <= ldb &&
                        lda % 4 == 0 && ldb % 4 == 0 && N % 2 == 0 && ldc % 2 == 0 &&
                        aligned(A, 16) && aligned(B, 16) && aligned(C, 8);
  const bool dgelu = epi == EPI_DGELU_ERF || epi == EPI_DGELU_TANH;
  const bool epi_ok =
      a_t ? (!b_t && epi == EPI_F32 && ws != nullptr && bias == nullptr && splits >= 1 &&
             kchunk > 0 && kchunk % TILE_K == 0 && (long long)splits * kchunk >= K &&
             (long long)(splits - 1) * kchunk < K)
      : b_t ? (bias == nullptr && (epi == EPI_F32 || epi == EPI_ADD_F32 || dgelu))
            : (epi == EPI_F32 || epi == EPI_GELU_ERF || epi == EPI_GELU_TANH);
  const bool aux_ok = (epi == EPI_ADD_F32 || dgelu)
                          ? aux != nullptr && ld_aux % 2 == 0 && aligned(aux, 8)
                          : true;
  const bool c2_ok = C2 == nullptr || (ldc2 % 2 == 0 && aligned(C2, 8));
  const bool colsum_ok = colparts == nullptr ? colsum == nullptr : colsum != nullptr && dgelu;
  if (!shape_ok || !epi_ok || !aux_ok || !c2_ok || !colsum_ok) return cudaErrorInvalidValue;

  Params p{M, N, K, K, 0, 0, 0, C, ldc, C2, ldc2, aux, ld_aux, bias, colparts};
  cudaError_t e;
  if (a_t) {  // weight gradient: f32 partial products, then one fixed-order sum
    p.C = ws;
    p.ldc = N;
    p.kchunk = kchunk;
    e = launch<true, false, EPI_PARTIAL>(p, A, lda, B, ldb, splits, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t total = (size_t)M * N;
    splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(ws, splits, M, N, C,
                                                                          ldc, 0);
    return static_cast<int>(cudaGetLastError());
  }
  if (b_t) {
    switch (epi) {
      case EPI_F32: e = launch<false, true, EPI_F32>(p, A, lda, B, ldb, 1, st); break;
      case EPI_ADD_F32: e = launch<false, true, EPI_ADD_F32>(p, A, lda, B, ldb, 1, st); break;
      case EPI_DGELU_ERF: e = launch<false, true, EPI_DGELU_ERF>(p, A, lda, B, ldb, 1, st); break;
      default: e = launch<false, true, EPI_DGELU_TANH>(p, A, lda, B, ldb, 1, st); break;
    }
  } else {
    switch (epi) {
      case EPI_F32: e = launch<false, false, EPI_F32>(p, A, lda, B, ldb, 1, st); break;
      case EPI_GELU_ERF: e = launch<false, false, EPI_GELU_ERF>(p, A, lda, B, ldb, 1, st); break;
      default: e = launch<false, false, EPI_GELU_TANH>(p, A, lda, B, ldb, 1, st); break;
    }
  }
  if (e != cudaSuccess || colparts == nullptr) return static_cast<int>(e);
  return static_cast<int>(colparts_reduce(colparts, (M + TILE_M - 1) / TILE_M, N, colsum, st));
}

int run_ce(int epi, const float* x, const float* table, const float* bias, int rows, int vocab,
           int hidden, float* C, int ldc, const int* targets, const float* lse, const float* scale,
           float* part_f, int* part_i, cudaStream_t st) {
  const bool fwd = epi == EPI_CE_FWD;
  const bool ok = rows > 0 && vocab > 0 && hidden > 0 && hidden % 4 == 0 && aligned(x, 16) &&
                  aligned(table, 16) && bias != nullptr && targets != nullptr &&
                  part_f != nullptr && (fwd ? part_i != nullptr : epi == EPI_CE_BWD) &&
                  (fwd || (C != nullptr && lse != nullptr && scale != nullptr)) &&
                  (C == nullptr || (ldc >= vocab && ldc % 2 == 0 && aligned(C, 8)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Params p{rows, vocab, hidden, hidden, 0, 0, 0, C, ldc, nullptr, 0, nullptr, 0, bias, nullptr,
           targets, lse, scale, part_f, part_i};
  const cudaError_t e = fwd ? launch<false, true, EPI_CE_FWD>(p, x, hidden, table, hidden, 1, st)
                            : launch<false, true, EPI_CE_BWD>(p, x, hidden, table, hidden, 1, st);
  return static_cast<int>(e);
}

int run_vq_cross(const float* z, int ldz, const float* center, const float* ec, int ldk, int M,
                 int N, int K, float* C, cudaStream_t st) {
  const bool ok = M > 0 && N > 0 && K > 0 && round4(K) <= ldz && round4(K) <= ldk &&
                  ldz % 4 == 0 && ldk % 4 == 0 && N % 2 == 0 && aligned(z, 16) &&
                  aligned(ec, 16) && aligned(C, 8) && center != nullptr;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Params p{M, N, K, K, 0, 0, 0, C, N, nullptr, 0, center, 0, nullptr, nullptr};
  return static_cast<int>(launch<false, true, EPI_VQ_CROSS>(p, z, ldz, ec, ldk, 1, st));
}

}  // namespace f32gemm
}  // namespace kvq

extern "C" {

// C (M, N) f32 = epi(op(A) @ op(B) [+ bias]) on f32 operands: a_t, A stored
// (K, M) (EPI_F32 only, through `splits` partials of kchunk rows of K in ws,
// (splits, M, N) f32); b_t, B stored (N, K); the epilogues and the rest as
// kvq::f32gemm::run_gemm. Returns a cudaError_t code.
int kvq_gemm_f32(int a_t, int b_t, const void* A, int lda, const void* B, int ldb, int M, int N,
                 int K, int epi, int splits, int kchunk, void* C, int ldc, void* C2, int ldc2,
                 const void* aux, int ld_aux, const void* bias, void* ws, void* colparts,
                 void* colsum, void* stream) {
  return kvq::f32gemm::run_gemm(
      a_t, b_t, static_cast<const float*>(A), lda, static_cast<const float*>(B), ldb, M, N, K,
      epi, splits, kchunk, static_cast<float*>(C), ldc, static_cast<float*>(C2), ldc2,
      static_cast<const float*>(aux), ld_aux, static_cast<const float*>(bias),
      static_cast<float*>(ws), static_cast<float*>(colparts), static_cast<float*>(colsum),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
