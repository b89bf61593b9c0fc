// int8 cross-attention of the decode loop (K9).
//
// Replaces qasr_ijcnlp_tpu/ops/decode_attn.py `_kernel`.  The cross K/V of a
// decoder layer are int8 codes (B, H, Tp, Dh) with one fp32 scale per
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
// once.  Any head width Dh <= 256 runs.  Bound on the H100: the code and
// scale bytes (31.5 + 2.0 MB per layer and step at large-v3, B = 8), so the
// loads are the design: a position's Dh codes are one Dh-byte row, read as
// Dh / 16 16-byte loads by one thread for the logits and, for PV, in 64-code
// column chunks as 4-byte loads by 16 neighbouring threads.  Where Dh is not
// a multiple of 16 the rows are not 16-byte aligned, and the kernel reads
// single bytes instead (kVec = false) and masks the ragged last chunk.
// Positions >= t_real (the padding, whose scale 0 would give a logit of 0,
// not -inf) are never read.
#include <algorithm>

#include "common.cuh"

namespace qasr {

constexpr int I8_THREADS = 256;
constexpr int I8_CHUNK = 64;  // PV columns per pass: 16 threads x 4 codes

// Byte i (0..3) of a 32-bit word as a signed value.
__device__ __forceinline__ float code_at(int w, int i) {
  return (float)((w << (24 - 8 * i)) >> 24);
}

template <typename T, int RB, bool kVec>
__global__ void __launch_bounds__(I8_THREADS)
int8_xattn_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                  const float* __restrict__ sk, const int8_t* __restrict__ v8,
                  const float* __restrict__ sv, float* __restrict__ out, int G, int T_new,
                  int H, int Tp, int Dh, int t_real, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;              // [RB][Dh] this pass's q rows, fp32, scaled
  float* lg = qs + RB * Dh;      // [RB][Tp] logits, then weights
  float* part = lg + RB * Tp;    // [16 slices][RB][I8_CHUNK] PV partial sums
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int D = H * Dh, R = G * T_new;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int8_t* kb = k8 + (size_t)bh * Tp * Dh;
  const int8_t* vb = v8 + (size_t)bh * Tp * Dh;
  const float* skb = sk + (size_t)bh * Tp;
  const float* svb = sv + (size_t)bh * Tp;

  for (int r0 = 0; r0 < R; r0 += RB) {
    const int rows = min(RB, R - r0);
    __syncthreads();  // the previous pass is done with qs, lg and part
    for (int i = tid; i < RB * Dh; i += I8_THREADS) {
      const int rr = i / Dh, d = i % Dh, r = r0 + rr;
      float v = 0.f;
      if (rr < rows) {
        const int g = r / T_new, t = r % T_new;
        v = to_f(q[((size_t)(b * G + g) * T_new + t) * D + h * Dh + d]) * scale;
      }
      qs[i] = v;
    }
    __syncthreads();

    // Logits, one thread per position.
    for (int t = tid; t < t_real; t += I8_THREADS) {
      const int8_t* kp = kb + (size_t)t * Dh;
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
      if (kVec) {
        for (int j = 0; j < Dh / 16; ++j) {
          const int4 w4 = reinterpret_cast<const int4*>(kp)[j];
          const int words[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float c = code_at(words[e], i);
              const int d = j * 16 + e * 4 + i;
#pragma unroll
              for (int r = 0; r < RB; ++r) acc[r] = fmaf(qs[r * Dh + d], c, acc[r]);
            }
        }
      } else {
        for (int d = 0; d < Dh; ++d) {
          const float c = (float)kp[d];
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[r] = fmaf(qs[r * Dh + d], c, acc[r]);
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

    // PV, one 64-column chunk at a time: thread (slice, dg) sums columns
    // c0 + 4 dg .. c0 + 4 dg + 3 over positions slice, slice + 16, ...; a
    // warp reads two neighbouring rows' 64-byte chunks.
    const int slice = tid >> 4, dg = tid & 15;
    for (int c0 = 0; c0 < Dh; c0 += I8_CHUNK) {
      __syncthreads();  // weights final / the previous chunk's sums written out
      const int d0 = c0 + dg * 4;
      const int nd = min(4, Dh - d0);  // this thread's columns in the chunk
      float acc[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      if (nd > 0) {
        for (int t = slice; t < t_real; t += 16) {
          const int8_t* vp = vb + (size_t)t * Dh + d0;
          float c[4];
          if (kVec) {
            const char4 cv = *reinterpret_cast<const char4*>(vp);
            c[0] = cv.x, c[1] = cv.y, c[2] = cv.z, c[3] = cv.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) c[k] = k < nd ? (float)vp[k] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float w = lg[r * Tp + t];
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(w, c[k], acc[r][k]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) part[(slice * RB + r) * I8_CHUNK + dg * 4 + k] = acc[r][k];
      __syncthreads();
      for (int i = tid; i < rows * I8_CHUNK; i += I8_THREADS) {
        const int rr = i / I8_CHUNK, dd = i % I8_CHUNK, d = c0 + dd;
        if (d >= Dh) continue;
        float s = 0.f;
        for (int sl = 0; sl < 16; ++sl) s += part[(sl * RB + rr) * I8_CHUNK + dd];
        const int r = r0 + rr, g = r / T_new, t = r % T_new;
        out[((size_t)(b * G + g) * T_new + t) * D + h * Dh + d] = s;
      }
    }
  }
}

template <typename T, int RB, bool kVec>
int launch_int8_xattn(const T* q, const int8_t* k8, const float* sk, const int8_t* v8,
                      const float* sv, float* out, int B, int G, int T_new, int H, int Tp,
                      int Dh, int t_real, float scale, cudaStream_t s) {
  const int smem = 4 * (RB * Dh + RB * Tp + 16 * RB * I8_CHUNK);
  QASR_TRY(cudaFuncSetAttribute(int8_xattn_kernel<T, RB, kVec>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  int8_xattn_kernel<T, RB, kVec><<<B * H, I8_THREADS, smem, s>>>(
      q, k8, sk, v8, sv, out, G, T_new, H, Tp, Dh, t_real, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int run_rows(const T* q, const int8_t* k8, const float* sk, const int8_t* v8,
             const float* sv, float* out, int B, int G, int T_new, int H, int Tp, int Dh,
             int t_real, float scale, cudaStream_t s) {
  const int R = G * T_new;
  if (R == 1)
    return launch_int8_xattn<T, 1, kVec>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh,
                                         t_real, scale, s);
  if (R <= 4)
    return launch_int8_xattn<T, 4, kVec>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh,
                                         t_real, scale, s);
  return launch_int8_xattn<T, 8, kVec>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh,
                                       t_real, scale, s);
}

template <typename T>
int run_int8_xattn(const T* q, const int8_t* k8, const float* sk, const int8_t* v8,
                   const float* sv, float* out, int B, int G, int T_new, int H, int Tp,
                   int Dh, int t_real, float scale, cudaStream_t s) {
  if (Dh % 16 == 0)
    return run_rows<T, true>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh, t_real, scale,
                             s);
  return run_rows<T, false>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh, t_real, scale, s);
}

}  // namespace qasr

using namespace qasr;

// q (B G, T_new, H Dh) in the compute dtype, group-major rows; codes
// (B, H, Tp, Dh) int8, 16-byte aligned; scales (B, H, Tp) fp32; out (B G,
// T_new, H Dh) fp32; 1 <= t_real <= Tp; 1 <= Dh <= 256; scale = Dh^-0.5 in
// fp32.
extern "C" int qasr_int8_cross_attention(int dtype, const void* q, const void* k8,
                                         const void* sk, const void* v8, const void* sv,
                                         void* out, int B, int G, int T_new, int H, int Tp,
                                         int Dh, int t_real, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* kc = (const int8_t*)k8;
  const int8_t* vc = (const int8_t*)v8;
  if (dtype == kF32)
    return run_int8_xattn<float>((const float*)q, kc, (const float*)sk, vc, (const float*)sv,
                                 (float*)out, B, G, T_new, H, Tp, Dh, t_real, scale, s);
  return run_int8_xattn<__nv_bfloat16>((const __nv_bfloat16*)q, kc, (const float*)sk, vc,
                                       (const float*)sv, (float*)out, B, G, T_new, H, Tp, Dh,
                                       t_real, scale, s);
}
