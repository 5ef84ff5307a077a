// The GEMM for Hopper (sm_90a): C = epi(op(A) @ op(B)), bf16 operands, f32
// accumulation: every projection of the fused BertLayer forward and backward,
// and every product of the fused MLM head + CE.
//
// Serves TPU kernels #1 (kindergarten_vq_vae_tpu/ops/layer_pallas.py
// `_layer_fwd_kernel`, l.489: the forward's 4 / 7 projections, bias and GELU
// fused), #2 (`_layer_bwd_kernel`, l.552: the data gradients dY @ W^T with
// the residual add or the GELU gradient fused, and the weight gradients
// X^T @ dY over all rows), #9 (ops/head_ce_pallas.py `_fwd_kernel`, l.67:
// x @ E^T with the CE reductions fused) and #10 (`_bwd_kernel`, l.179: the
// logits recomputed with the CE gradient fused, then dx = g @ E), and the
// table gradient g^T @ x beside #10 (l.365). The CE epilogues live in
// head_ce.cu, the one source that instantiates them.
//
// What bounds it on the H100: at 2048 x 12 rows every projection is
// compute-bound (K = 768 or 3072 against N >= 768; the head's 30,522-wide
// vocabulary likewise: far above the card's ~295 operations per byte), so
// the bound is the 989 TFLOP/s of the bf16 tensor cores, which only `wgmma`
// reaches; `mma.sync` GEMMs (16 x 16 x 16 fragments, two cp.async
// stages) ran at 11-15% of it on the same products.
//
// What the design does about it:
// - one persistent CTA per SM walks a queue of 128 x BN output tiles (BN
//   picked by the host, ops/gemm.py `gemm_plan`, from the epilogue, the tile
//   count and the SM count), so one tile's stores overlap the next tile's
//   loads and products;
// - a producer warp keeps TMA loads (cp.async.bulk.tensor.2d, 128-byte
//   swizzle, out-of-bounds rows and columns zero-filled) in flight into a
//   ring of 3-5 stages of 128 x 64 A and 64 x BN B tiles, each stage with a
//   "full" and an "empty" mbarrier;
// - two consumer warpgroups issue wgmma.m64nBNk16 on their 64-row halves,
//   with one wgmma group in flight while the previous stage is released;
//   setmaxnreg moves registers from the producer to the consumers;
// - both operands are read from shared memory in the layout they have in
//   device memory, K-major or MN-major through the descriptors' transpose
//   bits, so NN (forward), NT (dgrad) and TN (wgrad) need no copy;
// - the epilogue keeps the rounding points of the JAX package's kernels.
//   The weight gradients' f32 partial products over row chunks go
//   straight from the accumulators (each thread holds column pairs of rows r
//   and r + 8), summed in a fixed order by splitk_reduce_kernel:
//   deterministic, rounded once. Every other epilogue is staged: the
//   consumers drop the f32 tile (bf16 for the CE epilogues, which round
//   there) into shared memory and go on to the next tile, while one (BN
//   192) or two (BN 128, for the GELU, its gradient, the residual adds and
//   the CE epilogues) epilogue warpgroups add the bias, read the aux, apply
//   the GELU or reduce the CE and store in coalesced rows, so that work
//   overlaps the tensor cores. The GELU gradient's epilogue also sums its
//   f32 du over each tile's rows in a fixed order (b1's column partials),
//   so the du is stored only in bf16. Measured on an
//   H100 80GB HBM3 (PERF.md), the epilogue was what held the short (K =
//   768) products back, not the mainloop.
// The PTX wrappers are written by hand (sm90_ptx.cuh, shared with the f32
// GEMM); the build is the CUDA toolkit's alone.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "layer_common.cuh"
#include "sm90_ptx.cuh"

namespace kvq {
namespace sm90 {

constexpr int TILE_M = 128, TILE_K = 64;
constexpr int ATOM_BYTES = 8192;       // one 64 x 64 bf16 box, 128-byte rows
constexpr int SMEM_MAX = 232448;       // dynamic shared memory a block may use (227 KB)

// The kernel's configuration for a tile width and an epilogue. Split-K
// partials (the weight gradients: long K, plain f32 stores) are stored by the
// consumers from their registers. Every other epilogue is "staged": the
// consumers drop the f32 tile into shared memory and go on to the next
// tile's products, while one or two epilogue warpgroups add the bias, read
// the aux, apply the GELU or its gradient and store, so that work overlaps
// the tensor cores instead of following them.
template <int BN, int EPI>
struct Cfg {
  static constexpr bool STAGED = EPI != EPI_PARTIAL;
  // epilogue warpgroups: two behind 128-wide tiles, one behind 192-wide ones,
  // since ptxas compiles every role within the launch's 65536 / THREADS
  // registers and a 192-wide wgmma needs 122
  static constexpr int EPI_WGS = !STAGED ? 0 : BN == 128 ? 2 : 1;
  static constexpr int THREADS = 128 * (3 + EPI_WGS);    // producer, 2 consumers, epilogue
  // registers a thread of each role holds after setmaxnreg; the CTA's pool
  // (its threads times the count they start with) must cover them all,
  // which the host checks before the launch
  static constexpr int PRODUCER_REGS = STAGED ? 24 : 40;
  static constexpr int CONSUMER_REGS = !STAGED ? 232 : EPI_WGS == 2 ? 136 : 160;
  static constexpr int EPILOGUE_REGS = 88;
  static constexpr int POOL = 128 * PRODUCER_REGS + 256 * CONSUMER_REGS +
                              128 * EPI_WGS * EPILOGUE_REGS;
  static constexpr int A_BYTES = TILE_M * TILE_K * 2;
  static constexpr int B_BYTES = BN * TILE_K * 2;
  // the CE epilogues (head_ce.cu) take the products rounded to bf16, where
  // the logits round them; the others f32
  static constexpr bool CE = EPI == EPI_CE_FWD || EPI == EPI_CE_BWD;
  // a staging row: BN + 8 elements, a 32- (f32) or 16-byte (bf16) shift, so
  // the consumers' stores meet no bank conflicts
  static constexpr int STG_LD = BN + 8;
  static constexpr int STG_BYTES = STAGED ? TILE_M * STG_LD * (CE ? 2 : 4) : 0;
  static constexpr int BAR_BYTES = 128;
  static constexpr int STAGES_FIT =
      (SMEM_MAX - 1024 - BAR_BYTES - STG_BYTES) / (A_BYTES + B_BYTES);
  static constexpr int STAGES = STAGES_FIT < 6 ? STAGES_FIT : 6;
  // the ring, the staging tile, the 1024-byte alignment of the swizzled tiles, the barriers
  static constexpr int BYTES = STAGES * (A_BYTES + B_BYTES) + STG_BYTES + 1024 + BAR_BYTES;
  static_assert(STAGES >= 3 && 2 * STAGES + 2 <= BAR_BYTES / 8, "ring of 3 to 6 stages");
};

// The CE epilogues' operands (head_ce.cu; null elsewhere): per row the
// target, and for EPI_CE_BWD the lse and the gradient's scale; the partials.
struct CeArgs {
  const int* targets;
  const float* lse;
  const float* scale;
  float* part_f;          // EPI_CE_FWD: (3, vocab tiles, M) f32; EPI_CE_BWD: (row tiles, N)
  int* part_i;            // EPI_CE_FWD: (vocab tiles, M) first argmax columns
};

// What one GEMM call needs besides its operands' tensor maps.
struct Args {
  int M, N, K;
  int kchunk;             // K range of one split, a multiple of TILE_K
  int splits;             // > 1 only with EPI_PARTIAL
  int tiles_m, tiles_n;
  void* C;                // EPI_PARTIAL: the f32 workspace (splits, M, ldc)
  int ldc;
  void* C2;               // may be null: the pre-GELU u (bf16) or the f32 du
  int ldc2;
  const void* aux;        // f32 residual (EPI_ADD_*) or bf16 u (EPI_DGELU_*)
  int ld_aux;
  const float* bias;      // may be null
  CeArgs ce;
  float* colpart;         // may be null: EPI_DGELU_*'s column partials of the f32 du, (tiles_m, N)
};

// wgmma.mma_async m64nNk16 bf16 -> f32, A and B from shared memory; TA / TB
// 1 for an MN-major operand. scale_d 0 starts the sum.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(BN == 128 || BN == 192 || BN == 256, "tile widths 128, 192 and 256");
  if constexpr (BN == 128)
    wgmma_n128<TA, TB>(d, da, db, scale_d);
  else if constexpr (BN == 192)
    wgmma_n192<TA, TB>(d, da, db, scale_d);
  else
    wgmma_n256<TA, TB>(d, da, db, scale_d);
}

// ------------------------------------------------------------- epilogue
// The epilogue's second input at (row, col..col + 1): the f32 residual of
// EPI_ADD_*, the bf16 pre-GELU u of EPI_DGELU_*, nothing for the others.
template <int EPI>
struct Aux {
  static constexpr bool F32 = EPI == EPI_ADD_F32 || EPI == EPI_ADD_BF16;
  static constexpr bool BF16 = EPI == EPI_DGELU_ERF || EPI == EPI_DGELU_TANH;
  typedef typename std::conditional<F32, float2, __nv_bfloat162>::type T;
  static constexpr int BYTES = F32 ? 4 : BF16 ? 2 : 0;

  __device__ __forceinline__ static T load(const Args& p, int row, int col) {
    const size_t o = (size_t)row * p.ld_aux + col;
    if constexpr (F32)
      return *reinterpret_cast<const float2*>(static_cast<const float*>(p.aux) + o);
    else
      return *reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p.aux) + o);
  }
};

// The staged epilogue of columns col and col + 1 of one row (col even, N
// even: both inside): the products plus the bias where there is one; `a` the
// epilogue's aux pair. The rounding points are the JAX kernels' (bf16 out
// after the f32 bias, GELU or residual add). Returns EPI_DGELU_*'s f32 du
// pair, before its rounding (the others: the products).
template <int EPI>
__device__ __forceinline__ float2 store_pair(const Args& p, int row, int col, float v0, float v1,
                                             typename Aux<EPI>::T a) {
  const size_t o = (size_t)row * p.ldc + col;
  if constexpr (EPI == EPI_F32) {
    *reinterpret_cast<float2*>(static_cast<float*>(p.C) + o) = make_float2(v0, v1);
  } else if constexpr (EPI == EPI_BF16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C) + o) = __floats2bfloat162_rn(v0, v1);
  } else if constexpr (EPI == EPI_GELU_ERF || EPI == EPI_GELU_TANH) {
    if (p.C2 != nullptr)  // the pre-GELU u, a training residual
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C2) + (size_t)row * p.ldc2 + col) =
          __floats2bfloat162_rn(v0, v1);
    const float g0 = EPI == EPI_GELU_ERF ? gelu_erf(v0) : gelu_tanh(v0);
    const float g1 = EPI == EPI_GELU_ERF ? gelu_erf(v1) : gelu_tanh(v1);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C) + o) = __floats2bfloat162_rn(g0, g1);
  } else if constexpr (EPI == EPI_ADD_F32 || EPI == EPI_ADD_BF16) {
    v0 += a.x;
    v1 += a.y;
    if constexpr (EPI == EPI_ADD_F32)
      *reinterpret_cast<float2*>(static_cast<float*>(p.C) + o) = make_float2(v0, v1);
    else
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C) + o) = __floats2bfloat162_rn(v0, v1);
  } else {
    static_assert(EPI == EPI_DGELU_ERF || EPI == EPI_DGELU_TANH, "unknown epilogue");
    const float u0 = __low2float(a), u1 = __high2float(a);
    const float d0 = v0 * (EPI == EPI_DGELU_ERF ? gelu_erf_grad(u0) : gelu_tanh_grad(u0));
    const float d1 = v1 * (EPI == EPI_DGELU_ERF ? gelu_erf_grad(u1) : gelu_tanh_grad(u1));
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.C) + o) = __floats2bfloat162_rn(d0, d1);
    if (p.C2 != nullptr)
      *reinterpret_cast<float2*>(static_cast<float*>(p.C2) + (size_t)row * p.ldc2 + col) =
          make_float2(d0, d1);
    return make_float2(d0, d1);
  }
  return make_float2(v0, v1);
}

// EPI_DGELU_*'s column partials of one 128 x BN tile: cs, this lane's
// columns 64 j + 2 lane (+1) summed over warp ew's rows of the tile in row
// order, parked in the tile's staging row ew (which warp ew alone read, and
// has read); then the warps' rows added in warp order, each column by one
// thread, into colpart[m0 / TILE_M, n0 + c]. Whichever CTA runs the tile
// writes the same bits.
template <int BN, int WARPS, int J>
__device__ __forceinline__ void store_colpart(const Args& p, float* stg, int ld, int m0, int n0,
                                              int ew, int lane, const float2 (&cs)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) *reinterpret_cast<float2*>(stg + ew * ld + 64 * j + 2 * lane) = cs[j];
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
  for (int c = 32 * ew + lane; c < BN; c += 32 * WARPS) {
    if (n0 + c < p.N) {
      float sum = stg[c];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) sum += stg[w * ld + c];
      p.colpart[(size_t)(m0 / TILE_M) * p.N + n0 + c] = sum;
    }
  }
}

// Pulls the tile's aux rows into L2 while the mainloop runs (each of the
// epilogue's threads a few 128-byte lines), so that the epilogue's loads
// wait on L2 and not on memory.
template <int EPI, int BN>
__device__ __forceinline__ void prefetch_aux(const Args& p, int m0, int n0, int t, int threads) {
  constexpr int BYTES = Aux<EPI>::BYTES;
  if constexpr (BYTES > 0) {
    constexpr int LINES = BN * BYTES / 128;  // per row of the tile
    const int cols = min(BN, p.N - n0);
    for (int i = t; i < TILE_M * LINES; i += threads) {
      const int r = i / LINES, l = i % LINES;
      if (m0 + r < p.M && l * 128 < cols * BYTES) {
        const char* a = static_cast<const char*>(p.aux) +
                        ((size_t)(m0 + r) * p.ld_aux + n0) * BYTES + l * 128;
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(a));
      }
    }
  }
}

// The staged epilogue of one 128 x BN tile of the fused head + CE
// (EPI_CE_FWD, EPI_CE_BWD), run by the WARPS epilogue warps (this thread:
// warp ew, lane): it reads what it needs of its rows, waits on the `full`
// barrier's phase `parity`, then reduces the products, rounded to bf16, in
// `stg` (row stride ld). Defined in head_ce.cu, which alone instantiates it.
template <int EPI, int BN, int WARPS>
__device__ void ce_tile(const Args& p, bf16* stg, int ld, int m0, int n0, int ew, int lane,
                        uint32_t full, uint32_t parity);

// ---------------------------------------------------------------- kernel
// A: A_MN false, (M, K) row-major, tensor map (rows M, cols K), box 64 x 128;
//    A_MN true, stored (K, M) row-major, map (rows K, cols M), box 64 x 64.
// B: B_MN true, (K, N) row-major, map (rows K, cols N), box 64 x 64;
//    B_MN false, stored (N, K) row-major, map (rows N, cols K), box 64 x BN.
// Work unit u: split z = u / (tiles_m * tiles_n), then the row tile, then
// the column tile (fastest, so CTAs in flight share their A rows in L2).
// Warpgroup 0 is the producer, 1 and 2 the consumers (rows [0, 64) and
// [64, 128) of the tile), 3 the epilogue of a staged configuration.
template <int BN, bool A_MN, bool B_MN, int EPI>
__global__ void __launch_bounds__(Cfg<BN, EPI>::THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const Args p) {
  typedef Cfg<BN, EPI> S;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t a_base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's 1024-byte atoms
  const uint32_t b_base = a_base + STAGES * S::A_BYTES;
  const uint32_t stg_base = b_base + STAGES * S::B_BYTES;
  const uint32_t bar_base = stg_base + S::STG_BYTES;
  float* stg = reinterpret_cast<float*>(smem_raw + (stg_base - smem_u32(smem_raw)));
  auto full = [&](int s) { return bar_base + 8u * s; };
  auto empty = [&](int s) { return bar_base + 8u * (STAGES + s); };
  const uint32_t staged_full = bar_base + 16u * STAGES, staged_empty = staged_full + 8u;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's arrive, with the stage's bytes
      mbar_init(empty(s), 2);  // one arrive from each consumer warpgroup
    }
    if (S::STAGED) {
      mbar_init(staged_full, 256);   // every consumer thread has written its part
      mbar_init(staged_empty, 128 * S::EPI_WGS);  // every epilogue thread has read the tile
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int per_split = p.tiles_m * p.tiles_n, units = per_split * p.splits;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------ producer warpgroup
    setmaxnreg_dec<S::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch(&map_a);
      tma_prefetch(&map_b);
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int z = u / per_split, r = u % per_split;
        const int m0 = (r / p.tiles_n) * TILE_M, n0 = (r % p.tiles_n) * BN;
        const int kbeg = z * p.kchunk, kend = min(p.K, kbeg + p.kchunk);
        for (int k = kbeg; k < kend; k += TILE_K) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), S::A_BYTES + S::B_BYTES);
          const uint32_t sa = a_base + stage * S::A_BYTES, sb = b_base + stage * S::B_BYTES;
          if constexpr (A_MN) {
            tma_load(sa, &map_a, full(stage), m0, k);
            tma_load(sa + ATOM_BYTES, &map_a, full(stage), m0 + 64, k);
          } else {
            tma_load(sa, &map_a, full(stage), k, m0);
          }
          if constexpr (B_MN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(sb + j * ATOM_BYTES, &map_b, full(stage), n0 + 64 * j, k);
          } else {
            tma_load(sb, &map_b, full(stage), k, n0);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else if (wg <= 2) {
    // ------------------------------------------- two consumer warpgroups
    setmaxnreg_inc<S::CONSUMER_REGS>();
    const int c = wg - 1;  // rows [64 c, 64 c + 64) of the tile
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    int stage = 0;
    uint32_t phase = 0, staged = 0;
    float acc[BN / 2];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int z = u / per_split, r = u % per_split;
      const int m0 = (r / p.tiles_n) * TILE_M, n0 = (r % p.tiles_n) * BN;
      const int kbeg = z * p.kchunk, kend = min(p.K, kbeg + p.kchunk);
      const int nk = (kend - kbeg + TILE_K - 1) / TILE_K;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      int prev = 0;
      for (int i = 0; i < nk; ++i) {
        mbar_wait(full(stage), phase);
        const uint32_t sa = a_base + stage * S::A_BYTES + c * ATOM_BYTES;
        const uint32_t sb = b_base + stage * S::B_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TILE_K / 16; ++kk) {
          // 16 deeper: 16 rows of 128 bytes (MN-major) or 32 bytes along the row (K-major)
          const uint64_t da = A_MN ? sw128_desc(sa + kk * 2048, ATOM_BYTES, 1024)
                                   : sw128_desc(sa + kk * 32, 16, 1024);
          const uint64_t db = B_MN ? sw128_desc(sb + kk * 2048, ATOM_BYTES, 1024)
                                   : sw128_desc(sb + kk * 32, 16, 1024);
          wgmma<BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db, (i | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (i > 0 && t == 0) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (nk > 0 && t == 0) mbar_arrive(empty(prev));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);

      // accumulator j of chunk q (8 columns): row 16 warp + lane / 4 (+ 8 for
      // j = 2, 3), columns 8 q + 2 (lane % 4) + (j % 2)
      const int row = 64 * c + 16 * warp + lane / 4;
      if constexpr (S::STAGED) {
        mbar_wait(staged_empty, staged ^ 1);  // the epilogue has read the last tile
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          const int col = 8 * q + 2 * (lane % 4);
          if constexpr (S::CE) {
            bf16* s16 = reinterpret_cast<bf16*>(stg);
            *reinterpret_cast<__nv_bfloat162*>(s16 + row * S::STG_LD + col) =
                __floats2bfloat162_rn(acc[4 * q], acc[4 * q + 1]);
            *reinterpret_cast<__nv_bfloat162*>(s16 + (row + 8) * S::STG_LD + col) =
                __floats2bfloat162_rn(acc[4 * q + 2], acc[4 * q + 3]);
          } else {
            *reinterpret_cast<float2*>(stg + row * S::STG_LD + col) =
                make_float2(acc[4 * q], acc[4 * q + 1]);
            *reinterpret_cast<float2*>(stg + (row + 8) * S::STG_LD + col) =
                make_float2(acc[4 * q + 2], acc[4 * q + 3]);
          }
        }
        mbar_arrive(staged_full);
        staged ^= 1;
      } else {
        // split-K partials: ws[z] = acc, f32, straight from the registers
        float* ws = static_cast<float*>(p.C) + (size_t)z * p.M * p.ldc;
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          const int col = n0 + 8 * q + 2 * (lane % 4);
          if (col >= p.N) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (m0 + row + 8 * h < p.M)
              *reinterpret_cast<float2*>(ws + (size_t)(m0 + row + 8 * h) * p.ldc + col) =
                  make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
        }
      }
    }
  } else {
    // ------------------------------------------------ epilogue warpgroup
    if constexpr (S::STAGED) {
      setmaxnreg_dec<S::EPILOGUE_REGS>();
      constexpr int J = BN / 64, RB = 4;  // column pairs a thread holds in a row; rows a batch
      constexpr int WARPS = 4 * S::EPI_WGS;
      const int e = threadIdx.x - 384, ew = e / 32, lane = e % 32;
      const bool has_bias = p.bias != nullptr;
      uint32_t staged = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, staged ^= 1) {
        const int m0 = (u / p.tiles_n) * TILE_M, n0 = (u % p.tiles_n) * BN;
        if constexpr (S::CE) {
          ce_tile<EPI, BN, WARPS>(p, reinterpret_cast<bf16*>(stg), S::STG_LD, m0, n0, ew, lane,
                                  staged_full, staged);
        } else {
          prefetch_aux<EPI, BN>(p, m0, n0, e, 32 * WARPS);
          // the GELU gradient's du summed over the tile's rows, for b1
          constexpr bool COLSUM = EPI == EPI_DGELU_ERF || EPI == EPI_DGELU_TANH;
          float2 cs[J];
#pragma unroll
          for (int j = 0; j < J; ++j) cs[j] = make_float2(0.0f, 0.0f);
          float2 bias[J];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int col = n0 + 64 * j + 2 * lane;
            bias[j] = has_bias && col < p.N ? make_float2(p.bias[col], p.bias[col + 1])
                                            : make_float2(0.0f, 0.0f);
          }
          mbar_wait(staged_full, staged);
          // rows ew, ew + WARPS, ...: a warp stores 64 consecutive column pairs
          // of one row. A batch of RB rows loads its aux pairs and its products
          // first, so that the RB x J epilogues have no memory between them and
          // run side by side.
          for (int r0 = ew; r0 < TILE_M; r0 += WARPS * RB) {
            typename Aux<EPI>::T aux[RB][J] = {};
            float2 v[RB][J];
#pragma unroll
            for (int b = 0; b < RB; ++b)
#pragma unroll
              for (int j = 0; j < J; ++j) {
                const int row = m0 + r0 + WARPS * b, col = n0 + 64 * j + 2 * lane;
                if constexpr (Aux<EPI>::BYTES > 0)
                  if (row < p.M && col < p.N) aux[b][j] = Aux<EPI>::load(p, row, col);
                v[b][j] = *reinterpret_cast<const float2*>(stg + (r0 + WARPS * b) * S::STG_LD +
                                                           64 * j + 2 * lane);
              }
#pragma unroll
            for (int b = 0; b < RB; ++b)
#pragma unroll
              for (int j = 0; j < J; ++j) {
                const int row = m0 + r0 + WARPS * b, col = n0 + 64 * j + 2 * lane;
                if (row < p.M && col < p.N) {
                  float v0 = v[b][j].x, v1 = v[b][j].y;
                  if (has_bias) {
                    v0 += bias[j].x;
                    v1 += bias[j].y;
                  }
                  const float2 d = store_pair<EPI>(p, row, col, v0, v1, aux[b][j]);
                  if constexpr (COLSUM) {
                    cs[j].x += d.x;
                    cs[j].y += d.y;
                  }
                }
              }
          }
          if constexpr (COLSUM)
            if (p.colpart != nullptr)
              store_colpart<BN, WARPS, J>(p, stg, S::STG_LD, m0, n0, ew, lane, cs);
        }
        mbar_arrive(staged_empty);
      }
    }
  }
}

template <int BN, bool A_MN, bool B_MN, int EPI>
cudaError_t launch(const CUtensorMap& a, const CUtensorMap& b, const Args& p, int sms,
                   cudaStream_t st) {
  typedef Cfg<BN, EPI> S;
  auto* kernel = gemm_kernel<BN, A_MN, B_MN, EPI>;
  static unsigned configured = 0;  // a bit per device whose shared-memory limit is raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(configured >> dev & 1u)) {
    // setmaxnreg.inc waits for registers the CTA does not have: never launch so
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    if (attr.numRegs * S::THREADS < S::POOL) return cudaErrorInvalidConfiguration;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (e != cudaSuccess) return e;
    if (dev < 32) configured |= 1u << dev;
  }
  const int units = p.tiles_m * p.tiles_n * p.splits;
  kernel<<<units < sms ? units : sms, S::THREADS, S::BYTES, st>>>(a, b, p);
  return cudaGetLastError();
}

// Staged epilogues run 128- or 192-wide tiles (a 256-wide f32 staging tile
// leaves no room for a ring); the split-K partials 192 or 256.
template <bool A_MN, bool B_MN, int EPI>
cudaError_t launch_tile(int tile_n, const CUtensorMap& a, const CUtensorMap& b, const Args& p,
                        int sms, cudaStream_t st) {
  if (tile_n == 192) return launch<192, A_MN, B_MN, EPI>(a, b, p, sms, st);
  if constexpr (EPI == EPI_PARTIAL) {
    if (tile_n == 256) return launch<256, A_MN, B_MN, EPI>(a, b, p, sms, st);
  } else {
    if (tile_n == 128) return launch<128, A_MN, B_MN, EPI>(a, b, p, sms, st);
  }
  return cudaErrorInvalidValue;
}

// The instantiations, one source each (compiled in parallel): the forward's
// NN products, the data gradients' NT products, the weight gradients' TN
// split-K partials (the CE epilogues: head_ce.cu). cudaErrorInvalidValue for
// an epilogue a layout lacks.
cudaError_t launch_nn(int tile_n, int epi, const CUtensorMap& a, const CUtensorMap& b,
                      const Args& p, int sms, cudaStream_t st);
cudaError_t launch_nt(int tile_n, int epi, const CUtensorMap& a, const CUtensorMap& b,
                      const Args& p, int sms, cudaStream_t st);
cudaError_t launch_tn(int tile_n, const CUtensorMap& a, const CUtensorMap& b, const Args& p,
                      int sms, cudaStream_t st);

// C (M, N) = epi(op(A) @ op(B) [+ bias]) on stream st, op(A) = A^T when
// a_mn (A stored (K, M)), op(B) = B^T when !b_mn (B stored (N, K)). a_mn
// (the weight gradients) takes EPI_F32 / EPI_BF16 through `splits` f32
// partial products over K chunks of `kchunk` rows in ws (splits, M, N),
// summed in a fixed order; the others take splits = 1. colparts / colsum
// (both or neither; NT with EPI_DGELU_* only): the f32 du's column sums
// (N,) in colsum, through per-row-tile partials (ceil(M / TILE_M), N) in
// colparts summed in a fixed order. Leading dimensions are multiples of 8
// and every operand starts on 16 bytes. Returns a cudaError_t code
// (cudaErrorInvalidValue for what it does not take).
int run_gemm(int a_mn, int b_mn, const void* A, int lda, const void* B, int ldb, int M, int N,
             int K, int epi, int tile_n, int splits, int kchunk, void* C, int ldc, void* C2,
             int ldc2, const void* aux, int ld_aux, const float* bias, float* ws, int sms,
             cudaStream_t st, float* colparts = nullptr, float* colsum = nullptr);

}  // namespace sm90
}  // namespace kvq
