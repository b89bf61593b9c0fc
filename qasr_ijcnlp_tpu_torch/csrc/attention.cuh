// Online-softmax attention core shared by K4 (qasr_attention,
// encoder_block.cu) and K8 (qasr_packed_attention, flash.cu).
//
// out[b, t, h*64:(h+1)*64] = softmax_j(q_t . k_j, keys j < t_real) v_j for
// one head h of width 64, with q and k pre-scaled by the caller.  q, k and v
// are row-major with their own row strides, so K4 reads its fused (B, Tp, 3D)
// QKV buffer and K8 the model's three (B, T, D) tensors through the same
// code, and Tq may differ from Tk.  The (Tq, Tk) logits are never written:
// one block owns 64 query rows of one head of one batch item and walks the
// keys in 32-row shared-memory tiles with a running max and denominator.
// Key tiles at or past t_real are skipped whole (their weight is exactly 0).
// Bound on the H100: 4 * B * H * Tq * t_real * 64 FLOP on SIMT fp32 FMAs fed
// from shared memory (no tensor cores yet).
#pragma once

#include "common.cuh"

namespace qasr {

// encoder_block.cu instantiates the kernel with kRoundedSum = 1 and flash.cu
// with 0, so no instantiation is compiled twice.
constexpr int DH = 64;     // head width (every Whisper size)
constexpr int AQ = 64;     // query rows per block
constexpr int AK = 32;     // keys per shared-memory tile
constexpr int ATHREADS = 256;

// Thread layout: row r = tid / 4 owns one query row; its four threads
// (`part`) split the AK keys of a tile for QK^T (8 each) and the 64 output
// columns for PV (16 each, interleaved so shared reads are conflict-free).
// p is rounded to T for the PV product in both kernels.  The denominator
// sums the rounded p when kRoundedSum (K4: the TPU kernel's ones-augmented V
// sums what it multiplies) and the unrounded fp32 p otherwise (K8, as
// ops/flash.py `_packed_kernel` does).
template <typename T, int kRoundedSum>
__global__ void __launch_bounds__(ATHREADS)
attn_core_kernel(const T* __restrict__ q, int ldq, const T* __restrict__ k, int ldk,
                 const T* __restrict__ v, int ldv, T* __restrict__ out, int ldo, int Tq,
                 int Tk, int t_real) {
  __shared__ float Qs[AQ][DH + 1];
  __shared__ float Ks[AK][DH + 1];
  __shared__ float Vs[AK][DH];
  __shared__ float Ps[AQ][AK + 1];

  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const T* qb = q + (size_t)b * Tq * ldq + h * DH;
  const T* kb = k + (size_t)b * Tk * ldk + h * DH;
  const T* vb = v + (size_t)b * Tk * ldv + h * DH;

  for (int i = tid; i < AQ * DH; i += ATHREADS) {
    const int rr = i / DH, c = i % DH, t = q0 + rr;
    Qs[rr][c] = t < Tq ? to_f(qb[(size_t)t * ldq + c]) : 0.f;
  }

  float o[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) o[c] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const int n_tiles = (t_real + AK - 1) / AK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * AK;
    __syncthreads();  // Q loaded / previous tile's Ks, Vs, Ps consumed
    for (int i = tid; i < AK * DH; i += ATHREADS) {
      const int rr = i / DH, c = i % DH, t = k0 + rr;
      // Keys >= t_real are read as zeros: their weight is 0, and padding
      // rows may hold anything, so 0 * V must not meet a non-finite V.
      const bool ok = t < t_real;
      Ks[rr][c] = ok ? to_f(kb[(size_t)t * ldk + c]) : 0.f;
      Vs[rr][c] = ok ? to_f(vb[(size_t)t * ldv + c]) : 0.f;
    }
    __syncthreads();

    float s[8];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kk = part * 8 + j;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) acc = fmaf(Qs[r][d], Ks[kk][d], acc);
      s[j] = (k0 + kk < t_real) ? acc : -INFINITY;
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
      Ps[r][part * 8 + j] = p;
      ls += kRoundedSum ? p : e;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l_run = l_run * alpha + ls;
    m_run = m_new;
#pragma unroll
    for (int c = 0; c < 16; ++c) o[c] *= alpha;
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < AK; ++j) {
      const float p = Ps[r][j];
#pragma unroll
      for (int c = 0; c < 16; ++c) o[c] = fmaf(p, Vs[j][part + 4 * c], o[c]);
    }
  }

  const int t = q0 + r;
  if (t < Tq) {
    T* orow = out + ((size_t)b * Tq + t) * ldo + h * DH;
#pragma unroll
    for (int c = 0; c < 16; ++c) orow[part + 4 * c] = from_f<T>(o[c] / l_run);
  }
}

template <typename T, int kRoundedSum>
inline cudaError_t launch_attn_core(const T* q, int ldq, const T* k, int ldk, const T* v,
                                    int ldv, T* out, int ldo, int B, int Tq, int Tk,
                                    int n_head, int t_real, cudaStream_t s) {
  dim3 grid((Tq + AQ - 1) / AQ, n_head, B);
  attn_core_kernel<T, kRoundedSum>
      <<<grid, ATHREADS, 0, s>>>(q, ldq, k, ldk, v, ldv, out, ldo, Tq, Tk, t_real);
  return cudaGetLastError();
}

}  // namespace qasr
