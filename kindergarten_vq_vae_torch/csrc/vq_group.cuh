// The VQ's rows grouped by code, and the per-code sums over them in a fixed
// order (vq_bwd.cu): the codebook gradient (5+) past the one-pass kernel's
// codebooks, and the per-code statistics of vq_fwd.cu's general path.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace kvq {

constexpr int VQG_UNIT_ROWS = 1024;  // rows a unit of the counting sort (a block, a row a thread)

// The grouping's plan: the order of the sums (row blocks of rpb rows, W
// slots a block: the fixed order of the kernel before the grouping, kept to
// the bit), the counting sort's units (each row block cut into upb units of
// at most VQG_UNIT_ROWS rows) and the workspace, in ints: hist (units x n_e:
// counts, then the start of each (unit, code) in the sorted rows, then
// cursors), sorted (m row ids by code, each code's rows ascending), shorts
// (int4 a code: code, first, end) in code order and in order (the same,
// the most rows first), longs (the codes of more than VQG_LONG rows), lpos
// (a long code's first sorted row in each row block, and its end), meta
// (short and long codes, the sums' work counter), part (a long code's
// partials, a float a column of each row block).
struct VqGroup {
  int m, d, n_e;
  int rpb, n_rb, W;
  int upb, units;
  int long_max;
  size_t hist, sorted, shorts, order, longs, lpos, meta, part, ints;
  __host__ __device__ int unit_of(int row) const {
    const int b = row / rpb;
    return b * upb + (row - b * rpb) / VQG_UNIT_ROWS;
  }
};

// vec: the 16-byte path of the sums (d % 4 == 0 and 16-byte aligned rows),
// which set the one-pass kernel's slots, and so the order. The layout and
// G.ints do not depend on it: a grouping built on one path holds the
// other's sums.
VqGroup vq_group_plan(int m, int d, int n_e, bool vec);

// Whether the codebook gradient takes the grouped sums: the codebooks whose
// per-warp slabs of the one-pass kernel do not fit 4 to a block
bool vq_grouped_takes(int d, int n_e, bool vec);

// out[k, :] = sum over the rows i with idx[i] = k of the term of row i, in
// the order of the plan: the term z[i] (sumz) or (2 g) (E[k] - z[i]). With
// sumz, out[n_e d + k] = the count of code k and out[n_e d + n_e] the sum of
// rowdiff (m,) in the one-pass kernel's order; out is zero from the end of
// what is written to out_width. ws: G.ints ints, 16-byte aligned. counted:
// hist already holds the units' counts (the caller zeroed it and counted
// into it, at unit_of(row)); else this zeroes and counts it. grouped (not
// sumz): ws holds the whole grouping of these rows and codes (a forward's),
// and only the sums run. Returns a cudaError_t.
cudaError_t vq_grouped_sum(const VqGroup& G, bool sumz, const float* z, const int64_t* idx,
                           const float* codebook, const float* g, const float* rowdiff, int* ws,
                           float* out, int out_width, bool counted, bool grouped, bool vec,
                           cudaStream_t st);

}  // namespace kvq
