// What every attention entry shares, and the interface of the attention of
// sentences longer than 32 tokens (up to 512 queries and 512 keys) and of
// heads wider than 128 columns (any head_dim, any length up to 512), forward
// and backward, in bf16 and in f32: the path that attention.cuh (bf16) and
// attention_f32.cuh (f32) take where their one-warp-per-(sentence, head)
// kernels, which hold at most two m16 blocks of queries and of keys and 128
// columns, do not reach. Every caller of those two goes through
// it: the layer kernels (layer_fwd.cu #1; layer_bwd.cu #3 / #4 inside #2) and
// the standalone attention (sdpa.cu #11, #12, #13). The kernels are in
// attention_long.cu, built once into the library (not once for each file
// that includes this header); the design and what bounds them are written
// there.
//
// The function and its rounding points are the short path's: f32 scores q
// k^T * scale plus the finite NEG_INF of a masked key or of j > i under the
// causal mask (#13, WHERE_MASK: replaced by it), p = e / z with e = expf(x -
// max) over the real keys and the row's final max and sum (#13: e * (1 /
// z)), the hash-dropout keep mask of dropout_hash.cuh on the same ids (query
// row b * s_q + i, key j, op id op_base + h), p rounded to the compute dtype
// before p @ v; the backward recomputes p, takes dp = (g v^T) * kappa, t =
// rowsum(dp * p), ds = p (dp - t) * scale rounded to the compute dtype before
// dq and dk, and dv from the rounded p * kappa. In f32 the roundings are
// identities.
#pragma once

#include <cuda_runtime.h>

#include "dropout_hash.cuh"
#include "layer_common.cuh"

namespace kvq {

// The arguments of every attention kernel: T is bf16 (attention.cuh's
// AttArgs) or float (attention_f32.cuh's AttF32Args).
template <typename T>
struct AttnArgs {
  const T* q;
  const T* k;
  const T* v;
  const int* key_mask;  // (batch, s_k) int32 or null (all keys valid)
  const T* g;           // backward: the context gradient, rows of nh * hd
  T* out;               // forward: ctx; backward: dq
  T* dk;
  T* dv;
  int q_ld, kv_ld, out_ld, dkv_ld;
  int batch, nh, hd, s_q, s_k, causal, op_base;
  float scale;
  DropoutParams drop;
  float* stats;  // the 64-row tiles' backward (past 32 queries or keys): (batch * nh * s_q, 4)
                 // f32 scratch, each query row's max, sum of exp z, 1 / z and t
};

// The forward (attention_long.cu) of a (batch, nh) call with s_q or s_k
// above 32 or hd above 128; where_mask: #13's masks. Returns a CUDA error
// code.
int attention_long_fwd(const AttnArgs<bf16>& a, bool where_mask, cudaStream_t st);
int attention_long_fwd(const AttnArgs<float>& a, bool where_mask, cudaStream_t st);
// The backward: up to 32 queries and keys (head_dim past 128) one launch;
// past that two, dq by query tiles (writing a.stats), then dk and dv by key
// tiles (reading it).
int attention_long_bwd(const AttnArgs<bf16>& a, cudaStream_t st);
int attention_long_bwd(const AttnArgs<float>& a, cudaStream_t st);

}  // namespace kvq

// Internal linkage in the including file's own anonymous namespace, as
// attention.cuh.
namespace {

constexpr float NEG_INF = -1e9f;        // finite, as sdpa_pallas.py NEG_INF
constexpr int ATL_MAX_S = 512;          // BERT's max_position_embeddings

// what every attention entry takes: attention.cuh's and attention_f32.cuh's
// kernels up to 32 queries and keys and head_dim 128, attention_long.cu's
// beyond either, up to 512 queries and keys and any head_dim
inline bool attention_fits(int s_q, int s_k, int hd) {
  return s_q >= 1 && s_k >= 1 && s_q <= ATL_MAX_S && s_k <= ATL_MAX_S && hd >= 1;
}

}  // namespace
