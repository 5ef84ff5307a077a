// Counter-based hash dropout shared by the layer kernels (layer_fwd.cu,
// layer_bwd.cu). The same function as ops/dropout.py and as the JAX package's
// `_keep_2d` (ops/layer_pallas.py:142) / `_dropout_keep_scale`
// (ops/sdpa_pallas.py:77): murmur3 fmix32 of (absolute query row, column or
// within-sentence key position, op id, seed), all mod 2^32. The threshold and
// the scale come from the host (ops/dropout.py keep_threshold / keep_scale),
// so the device never recomputes them in f32.
#pragma once

#include <cstdint>

// op ids of the hidden sites (ops/dropout.py OP_*): after wo, wco and w2
constexpr uint32_t OP_ATTN_OUT = 1000u, OP_CROSS_OUT = 1001u, OP_MLP_OUT = 1002u;

struct DropoutParams {
  uint32_t seed;    // the int32 seed's bits
  uint32_t thresh;  // keep iff hash >= thresh
  float scale;      // 1 / (1 - rate), rounded to f32 on the host
  int on;           // 0: no dropout at this call (rate 0)
};

__device__ __forceinline__ uint32_t dropout_row_term(uint32_t row, uint32_t op, uint32_t seed) {
  return row * 0x9E3779B1u + (seed + op * 0xC2B2AE3Du);
}

__device__ __forceinline__ float dropout_keep(uint32_t row_term, uint32_t col,
                                              const DropoutParams& d) {
  uint32_t x = row_term ^ (col * 0x85EBCA77u);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= d.thresh ? d.scale : 0.0f;
}
