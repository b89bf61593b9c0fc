// SIMT online-softmax attention core of K4 (qasr_attention,
// encoder_block.cu, replacing qasr_ijcnlp_tpu/ops/encoder_block.py
// `_attn_kernel`), whose tiles K11 (attn_parts.cu) reuses.  K7 and K8 run
// on the tensor-core core of attention_tc.cuh instead.
//
// out[b, h, t, :dh] = softmax_j(q_t . k_j, keys j < t_real) v_j for one head
// h of any width dh <= 256, with q and k pre-scaled by the caller.  Each of
// q, k, v and out is addressed through its own (batch, head, row) element
// strides with unit column stride, so K4 reads its fused (B, Tp, 3D) QKV
// buffer in place, and Tq may differ from Tk.  The (Tq, Tk)
// logits are never written: one block owns 64 query rows of one head of one
// batch item and walks the keys in 32-row shared-memory tiles with a running
// max and denominator.  Key tiles at or past t_real are skipped whole (their
// weight is exactly 0).
//
// Head width: the kernel is compiled at padded widths W = 32, 64, 96, 128 and
// 256 and launched at the smallest W >= dh.  Columns dh..W-1 of the q, k and
// v tiles are zero-filled in shared memory (so they add exact zeros to every
// dot product) and never stored.  Shared memory is dynamic: (64 + 32) rows of
// W + 1 floats for q and k, 32 rows of W for v and a 64 x 33 tile of p, i.e.
// 41.6 KB at W = 64, 74.4 KB at 128 and 139.9 KB at 256 (over the 48 KB
// static limit, so every launch first raises the kernel's dynamic limit).
// Registers: each thread keeps W / 4 fp32 output columns (16 at W = 64, 32 at
// 128, 64 at 256) besides its 8 logits.  ptxas (CUDA 12.8) gives 48
// registers a thread at W = 32 and 64 (five 256-thread blocks fit an SM's
// 64 K registers), 118-122 at 96 and 121-127 at 128 and 256 (two blocks), so
// registers limit W >= 96 to two blocks per SM, and shared memory limits
// W = 256 to one.
//
// Bound on the H100: 4 * B * H * Tq * t_real * dh FLOP on SIMT fp32 FMAs fed
// from shared memory (K4 has not moved to the tensor cores yet), i.e.
// operations, not bytes.
#pragma once

#include "common.cuh"

namespace qasr {

// encoder_block.cu instantiates the kernel with kRoundedSum = 1; the 0 form
// (the unrounded sum) served K7 and K8 and is no longer instantiated.
constexpr int AQ = 64;     // query rows per block
constexpr int AK = 32;     // keys per shared-memory tile
constexpr int ATHREADS = 256;
constexpr int kMaxHeadWidth = 256;

// Element strides of one operand seen as (B, H, T, dh) with unit column
// stride.
struct Strides {
  long long b, h, t;
};

template <typename T>
struct AttnArgs {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  Strides sq, sk, sv, so;
  int Tq, Tk, t_real, dh;
};

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

// Thread layout: row r = tid / 4 owns one query row; its four threads
// (`part`) split the AK keys of a tile for QK^T (8 each) and the W output
// columns for PV (W / 4 each, interleaved so shared reads are conflict-free).
// p is rounded to T for the PV product in every kernel.  The denominator
// sums the rounded p when kRoundedSum (K4: the TPU kernel's ones-augmented V
// sums what it multiplies) and the unrounded fp32 p otherwise (K7 and K8, as
// ops/flash.py `_attn_kernel` and `_packed_kernel` do).
template <typename T, int W, int kRoundedSum>
__global__ void __launch_bounds__(ATHREADS) attn_core_kernel(const AttnArgs<T> a) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [AQ][W + 1]
  float* Ks = Qs + AQ * (W + 1);    // [AK][W + 1]
  float* Vs = Ks + AK * (W + 1);    // [AK][W]
  float* Ps = Vs + AK * W;          // [AQ][AK + 1]
  constexpr int C = W / 4;          // output columns per thread

  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const int dh = a.dh, t_real = a.t_real;
  const T* qb = a.q + b * a.sq.b + h * a.sq.h;
  const T* kb = a.k + b * a.sk.b + h * a.sk.h;
  const T* vb = a.v + b * a.sv.b + h * a.sv.h;

  for (int i = tid; i < AQ * W; i += ATHREADS) {
    const int rr = i / W, c = i % W, t = q0 + rr;
    Qs[rr * (W + 1) + c] = (t < a.Tq && c < dh) ? to_f(qb[t * a.sq.t + c]) : 0.f;
  }

  float o[C];
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const int n_tiles = (t_real + AK - 1) / AK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * AK;
    __syncthreads();  // Q loaded / previous tile's Ks, Vs, Ps consumed
    for (int i = tid; i < AK * W; i += ATHREADS) {
      const int rr = i / W, c = i % W, t = k0 + rr;
      // Keys >= t_real are read as zeros: their weight is 0, and padding
      // rows may hold anything, so 0 * V must not meet a non-finite V.
      const bool ok = t < t_real && c < dh;
      Ks[rr * (W + 1) + c] = ok ? to_f(kb[t * a.sk.t + c]) : 0.f;
      Vs[rr * W + c] = ok ? to_f(vb[t * a.sv.t + c]) : 0.f;
    }
    __syncthreads();

    float s[8];
    tile_logits<W>(Qs + r * (W + 1), Ks, part, s);
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (k0 + part * 8 + j >= t_real) s[j] = -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    // Tile 0 always holds key 0 < t_real, so m_new is finite from the start.
    const float m_new = fmaxf(m_run, mt);
    const float alpha = expf(m_run - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float e = expf(s[j] - m_new);
      const float p = rnd<T>(e);
      Ps[r * (AK + 1) + part * 8 + j] = p;
      ls += kRoundedSum ? p : e;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l_run = l_run * alpha + ls;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] *= alpha;
    __syncthreads();
    tile_pv<W>(Ps + r * (AK + 1), Vs, part, o);
  }

  const int t = q0 + r;
  if (t < a.Tq) {
    T* orow = a.out + b * a.so.b + h * a.so.h + t * a.so.t;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = part + 4 * c;
      if (col < dh) orow[col] = from_f<T>(o[c] / l_run);
    }
  }
}

template <typename T, int W, int kRoundedSum>
inline cudaError_t launch_attn_width(const AttnArgs<T>& a, int B, int n_head,
                                     cudaStream_t s) {
  constexpr int smem = attn_smem_bytes(W);
  const cudaError_t e = cudaFuncSetAttribute(
      attn_core_kernel<T, W, kRoundedSum>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Tq + AQ - 1) / AQ, n_head, B);
  attn_core_kernel<T, W, kRoundedSum><<<grid, ATHREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// Launch at the smallest compiled width that holds a.dh; a wider head (the
// wrappers refuse it first) is cudaErrorInvalidValue.
template <typename T, int kRoundedSum>
inline cudaError_t launch_attn_core(const AttnArgs<T>& a, int B, int n_head,
                                    cudaStream_t s) {
  if (a.dh < 1) return cudaErrorInvalidValue;
  if (a.dh <= 32) return launch_attn_width<T, 32, kRoundedSum>(a, B, n_head, s);
  if (a.dh <= 64) return launch_attn_width<T, 64, kRoundedSum>(a, B, n_head, s);
  if (a.dh <= 96) return launch_attn_width<T, 96, kRoundedSum>(a, B, n_head, s);
  if (a.dh <= 128) return launch_attn_width<T, 128, kRoundedSum>(a, B, n_head, s);
  if (a.dh <= kMaxHeadWidth) return launch_attn_width<T, 256, kRoundedSum>(a, B, n_head, s);
  return cudaErrorInvalidValue;
}

// Strides of a row-major (B, T, ld) tensor whose heads sit at columns
// h * dh (the packed layout of K4's QKV buffer and of K8's operands).
inline Strides packed_strides(int T, int ld, int dh) {
  return Strides{(long long)T * ld, (long long)dh, (long long)ld};
}

}  // namespace qasr
