// int8 cross-attention of the decode loop (K9).
//
// Replaces qasr_ijcnlp_tpu/ops/decode_attn.py `_kernel`.  The cross K/V of a
// decoder layer are int8 codes (B, H, Tp, 64) with one fp32 scale per
// (b, h, position); for the query rows of one (batch item, head):
//
//   logit_t = (q . code_k[t]) * scale_k[t]     (fp32; t >= t_real masked)
//   w = softmax(logit);  out = sum_t (w_t * scale_v[t]) code_v[t]
//
// with q read in the compute dtype and scaled by Dh^-0.5 in fp32, the K
// scale applied after the product and V's folded into the weights, as the
// TPU kernel does; the output is fp32.  One block serves one (b, h) and all
// its G * T_new query rows, RB rows per pass, so at the decode step (one
// row) and at the prompt (four rows) every code is read from device memory
// once.  Bound on the H100: the code and scale bytes (31.5 + 2.0 MB per
// layer and step at large-v3, B = 8), so the loads are the design: a
// position's 64 codes are one 64-byte row, read as four 16-byte loads by one
// thread for the logits and as 4-byte loads by 16 neighbouring threads for
// PV; positions >= t_real (the padding, whose scale 0 would give a logit of
// 0, not -inf) are never read.
#include <algorithm>

#include "common.cuh"

namespace qasr {

constexpr int I8_THREADS = 256;
constexpr int I8_DH = 64;

// Byte i (0..3) of a 32-bit word as a signed value.
__device__ __forceinline__ float code_at(int w, int i) {
  return (float)((w << (24 - 8 * i)) >> 24);
}

template <typename T, int RB>
__global__ void __launch_bounds__(I8_THREADS)
int8_xattn_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                  const float* __restrict__ sk, const int8_t* __restrict__ v8,
                  const float* __restrict__ sv, float* __restrict__ out, int G, int T_new,
                  int H, int Tp, int t_real, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                // [RB][64] this pass's q rows, fp32, scaled
  float* lg = smem + RB * I8_DH;   // [RB][Tp] logits, then weights; then PV partials
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int D = H * I8_DH, R = G * T_new;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int8_t* kb = k8 + (size_t)bh * Tp * I8_DH;
  const int8_t* vb = v8 + (size_t)bh * Tp * I8_DH;
  const float* skb = sk + (size_t)bh * Tp;
  const float* svb = sv + (size_t)bh * Tp;

  for (int r0 = 0; r0 < R; r0 += RB) {
    const int rows = min(RB, R - r0);
    __syncthreads();  // the previous pass is done with qs and lg
    for (int i = tid; i < RB * I8_DH; i += I8_THREADS) {
      const int rr = i / I8_DH, d = i % I8_DH, r = r0 + rr;
      float v = 0.f;
      if (rr < rows) {
        const int g = r / T_new, t = r % T_new;
        v = to_f(q[((size_t)(b * G + g) * T_new + t) * D + h * I8_DH + d]) * scale;
      }
      qs[i] = v;
    }
    __syncthreads();

    // Logits, one thread per position.
    for (int t = tid; t < t_real; t += I8_THREADS) {
      const int4* kp = reinterpret_cast<const int4*>(kb + (size_t)t * I8_DH);
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int4 w4 = kp[j];
        const int words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float c = code_at(words[e], i);
            const int d = j * 16 + e * 4 + i;
#pragma unroll
            for (int r = 0; r < RB; ++r) acc[r] = fmaf(qs[r * I8_DH + d], c, acc[r]);
          }
      }
      const float s = skb[t];
#pragma unroll
      for (int r = 0; r < RB; ++r) lg[r * Tp + t] = acc[r] * s;
    }
    __syncthreads();

    // fp32 softmax over t < t_real, one warp per row; then V's scale.
    for (int r = warp; r < rows; r += I8_THREADS / 32) {
      float* row = lg + r * Tp;
      float m = -INFINITY;
      for (int t = lane; t < t_real; t += 32) m = fmaxf(m, row[t]);
      m = warp_max(m);
      float s = 0.f;
      for (int t = lane; t < t_real; t += 32) {
        const float p = expf(row[t] - m);
        row[t] = p;
        s += p;
      }
      s = warp_sum(s);
      for (int t = lane; t < t_real; t += 32) row[t] = row[t] / s * svb[t];
    }
    __syncthreads();

    // PV: thread (slice, dg) sums columns 4 dg .. 4 dg + 3 over positions
    // slice, slice + 16, ...; a warp reads two neighbouring 64-byte rows.
    const int slice = tid >> 4, dg = tid & 15;
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int t = slice; t < t_real; t += 16) {
      const char4 cv = *reinterpret_cast<const char4*>(vb + (size_t)t * I8_DH + dg * 4);
      const float c[4] = {(float)cv.x, (float)cv.y, (float)cv.z, (float)cv.w};
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float w = lg[r * Tp + t];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(w, c[k], acc[r][k]);
      }
    }
    __syncthreads();  // every thread is done reading the weights
    float* part = lg;  // [16 slices][RB][64]
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) part[(slice * RB + r) * I8_DH + dg * 4 + k] = acc[r][k];
    __syncthreads();
    for (int i = tid; i < rows * I8_DH; i += I8_THREADS) {
      const int rr = i / I8_DH, d = i % I8_DH;
      float s = 0.f;
      for (int sl = 0; sl < 16; ++sl) s += part[(sl * RB + rr) * I8_DH + d];
      const int r = r0 + rr, g = r / T_new, t = r % T_new;
      out[((size_t)(b * G + g) * T_new + t) * D + h * I8_DH + d] = s;
    }
  }
}

template <typename T, int RB>
int launch_int8_xattn(const T* q, const int8_t* k8, const float* sk, const int8_t* v8,
                      const float* sv, float* out, int B, int G, int T_new, int H, int Tp,
                      int t_real, cudaStream_t s) {
  const int smem = 4 * (std::max(RB * Tp, 16 * RB * I8_DH) + RB * I8_DH);
  QASR_TRY(cudaFuncSetAttribute(int8_xattn_kernel<T, RB>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  int8_xattn_kernel<T, RB><<<B * H, I8_THREADS, smem, s>>>(
      q, k8, sk, v8, sv, out, G, T_new, H, Tp, t_real, 0.125f /* 64^-0.5 */);
  return (int)cudaGetLastError();
}

template <typename T>
int run_int8_xattn(const T* q, const int8_t* k8, const float* sk, const int8_t* v8,
                   const float* sv, float* out, int B, int G, int T_new, int H, int Tp,
                   int t_real, cudaStream_t s) {
  const int R = G * T_new;
  if (R == 1)
    return launch_int8_xattn<T, 1>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, t_real, s);
  if (R <= 4)
    return launch_int8_xattn<T, 4>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, t_real, s);
  return launch_int8_xattn<T, 8>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, t_real, s);
}

}  // namespace qasr

using namespace qasr;

// q (B G, T_new, H 64) in the compute dtype, group-major rows; codes
// (B, H, Tp, 64) int8; scales (B, H, Tp) fp32; out (B G, T_new, H 64) fp32;
// 1 <= t_real <= Tp.
extern "C" int qasr_int8_cross_attention(int dtype, const void* q, const void* k8,
                                         const void* sk, const void* v8, const void* sv,
                                         void* out, int B, int G, int T_new, int H, int Tp,
                                         int t_real, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* kc = (const int8_t*)k8;
  const int8_t* vc = (const int8_t*)v8;
  if (dtype == kF32)
    return run_int8_xattn<float>((const float*)q, kc, (const float*)sk, vc, (const float*)sv,
                                 (float*)out, B, G, T_new, H, Tp, t_real, s);
  return run_int8_xattn<__nv_bfloat16>((const __nv_bfloat16*)q, kc, (const float*)sk, vc,
                                       (const float*)sv, (float*)out, B, G, T_new, H, Tp,
                                       t_real, s);
}
