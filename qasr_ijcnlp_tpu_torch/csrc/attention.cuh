// The SIMT attention tiles that K11 (attn_parts.cu, the diagnostic split
// of the fused encoder attention's time) runs: one block of ATHREADS threads
// owns AQ query rows of one head and walks the keys in AK-row shared-memory
// tiles, four threads a query row.  tile_logits computes a thread's 8
// logits of a key tile, tile_pv its W / 4 output columns of P V, on fp32
// FMAs fed from shared memory.  These were the tiles of K4's SIMT attention
// core (PR 1 to PR 6); K4, K7 and K8 now run on the tensor-core core of
// attention_tc.cuh, and only the diagnostic keeps these.
//
// Shared memory of a block at padded width W (attn_smem_bytes): AQ rows of
// W + 1 floats for q, AK rows of W + 1 for k, AK rows of W for v and an
// AQ x (AK + 1) tile of p; 41.6 KB at K11's W = 64.
#pragma once

#include "common.cuh"

namespace qasr {

constexpr int AQ = 64;     // query rows per block
constexpr int AK = 32;     // keys per shared-memory tile
constexpr int ATHREADS = 256;

// Bytes of dynamic shared memory of one block at padded width W.
constexpr int attn_smem_bytes(int W) {
  return (int)sizeof(float) * (AQ * (W + 1) + AK * (W + 1) + AK * W + AQ * (AK + 1));
}

// s[j] = q . k over the W columns of a tile, for this thread's 8 keys
// (part * 8 + j) of the AK-key tile Ks ([AK][W + 1]); qr is its q row.
template <int W>
__device__ __forceinline__ void tile_logits(const float* qr, const float* Ks, int part,
                                            float s[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* kr = Ks + (part * 8 + j) * (W + 1);
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < W; ++d) acc = fmaf(qr[d], kr[d], acc);
    s[j] = acc;
  }
}

// o[c] += sum_j p_j V[j][part + 4 c] over the tile Vs ([AK][W]): this
// thread's W / 4 interleaved output columns; pr is its row of p.
template <int W>
__device__ __forceinline__ void tile_pv(const float* pr, const float* Vs, int part,
                                        float o[W / 4]) {
#pragma unroll 4
  for (int j = 0; j < AK; ++j) {
    const float p = pr[j];
#pragma unroll
    for (int c = 0; c < W / 4; ++c) o[c] = fmaf(p, Vs[j * W + part + 4 * c], o[c]);
  }
}

}  // namespace qasr
