// Encoder conv stem: mel -> conv1 (k3, p1) + GELU -> conv2 (k3, s2, p1) + GELU
// + positional embedding, written as the trunk input (B, Tp, D) with rows
// >= t_out zeroed.
//
// Replaces qasr_ijcnlp_tpu/ops/conv_stem.py `_stem_kernel` (K2, D <= 512)
// and `_stem_kernel_chunked` (K3, 512 < D <= 1024); the port runs it at
// every D a multiple of 128, large-v3's 1280 too (the JAX package leaves
// that stem to XLA).  The TPU kernels split mel into even/odd time phases
// so that every tap became a whole-array row shift; here every tap is a
// row view of one channels-last buffer, read by TMA, and each convolution
// is one tensor-core GEMM (gemm_tc.cuh) against its weight in tap-major
// (D, 3 C) layout:
//
// * mel_rows_kernel (one pass, 32 x 32 tiles through shared memory) turns
//   the (B, C0, Tm) fp32 mel into rows of C_pad channels (C0 zero-padded
//   to the k-slice), rounded to the compute dtype as the reference casts
//   mel first (f32: hi/lo slabs).  Item b's frame tau is row 2 b P + 2 +
//   tau of a pitch of 2 P rows; every other row is zero.
// * conv1: output row r reads rows r, r + 1, r + 2 (stride 1, three taps).
//   Row r is y1's frame tau = r mod 2P - 1; its epilogue writes
//   gelu(T(T(acc) + b1)) there, and zero for tau outside [0, Tm), straight
//   into conv2's input buffer, which so has one zero row in front of each
//   item (f32: hi/lo slabs).
// * conv2: output row m = b P + t reads y1 rows 2m, 2m + 1, 2m + 2
//   (stride 2, three taps: frames 2t - 1, 2t, 2t + 1 of item b), with no
//   im2col copy; the epilogue writes gelu(T(T(acc) + b2)) + pos for t <
//   t_out, exactly 0 for t_out <= t < Tp, and nothing for t = Tp (P = Tp
//   + 1 when Tp == t_out: item b's last frame then needs the row that
//   would be item b + 1's zero row).
//
// Bound on the H100: operations, 2 B Tm D 3 C0 + 2 B t_out D 3 D FLOP on
// the tensor cores (989 TFLOP/s bf16, 495 / 3 as f32's 3xTF32); conv2 is
// 90% of it at medium.  Each convolution's sum is rounded once, as XLA's
// stem and cuDNN do (the TPU kernels round each tap's product first).
#include "gemm_tc.cuh"

using namespace qasr;

namespace {

// xb[r, c] = T(mel[b, c, tau]) for r = 2 b P + 2 + tau, c < C0, tau in
// [0, Tm); 0 elsewhere.  Block (32, 8) over a 32-row x 32-channel tile.
template <typename T>
__global__ void mel_rows_kernel(const float* __restrict__ mel, T* __restrict__ xb, int C0,
                                int Tm, int P2, int C_pad, int rows) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  {
    const int r = r0 + tx, b = r / P2, tau = r - b * P2 - 2;
    const bool in = r < rows && tau >= 0 && tau < Tm;
    for (int i = ty; i < 32; i += 8) {
      const int c = c0 + i;
      tile[i][tx] = (in && c < C0) ? mel[((size_t)b * C0 + c) * Tm + tau] : 0.f;
    }
  }
  __syncthreads();
  const size_t slab = (size_t)rows * C_pad;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i;
    if (r < rows) store_operand(xb, (size_t)r * C_pad + c0 + tx, slab, rnd<T>(tile[tx][i]));
  }
}

// conv1 epilogue: y1 row m (frame m mod 2P - 1) = gelu(T(T(acc) + b1)).
template <typename T>
struct Conv1Ep {
  const T* b1;
  T* y1;
  int D, P2, Tm;
  size_t slab;
  __device__ __forceinline__ void operator()(int m, int n, float a0, float a1) const {
    const int tau = m % P2 - 1;
    float v0 = 0.f, v1 = 0.f;
    if (tau >= 0 && tau < Tm) {
      const float2 b = load2(b1 + n);
      v0 = gelu_erf(rnd<T>(rnd<T>(a0) + b.x));
      v1 = gelu_erf(rnd<T>(rnd<T>(a1) + b.y));
    }
    store_operand2(y1, (size_t)m * D + n, slab, v0, v1);
  }
};

// conv2 epilogue: out[b, t] = gelu(T(T(acc) + b2)) + pos[t], 0 past t_out.
template <typename T>
struct Conv2Ep {
  const T* b2;
  const T* pos;
  T* out;
  int D, P, t_out, Tp;
  __device__ __forceinline__ void operator()(int m, int n, float a0, float a1) const {
    const int b = m / P, t = m - b * P;
    if (t >= Tp) return;
    float v0 = 0.f, v1 = 0.f;
    if (t < t_out) {
      const float2 bb = load2(b2 + n), p = load2(pos + (size_t)t * D + n);
      v0 = rnd<T>(gelu_erf(rnd<T>(rnd<T>(a0) + bb.x))) + p.x;
      v1 = rnd<T>(gelu_erf(rnd<T>(rnd<T>(a1) + bb.y))) + p.y;
    }
    store2(out + ((size_t)b * Tp + t) * D + n, v0, v1);
  }
};

template <typename T>
int run_stem(const float* mel, const T* w1, const T* b1, const T* w2, const T* b2,
             const T* pos, T* xb, T* y1, T* out, int B, int C0, int C_pad, int Tm, int D,
             int t_out, int Tp, int P, cudaStream_t s) {
  const int rows = 2 * B * P;  // conv1's rows (and y1's): 2P an item
  if (P < t_out + 1 || P < Tp || C_pad < C0) return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + 31) / 32, (C_pad + 31) / 32);
  mel_rows_kernel<T><<<grid, dim3(32, 8), 0, s>>>(mel, xb, C0, Tm, 2 * P, C_pad, rows);
  QASR_TRY(cudaGetLastError());
  QASR_TRY(launch_wgmma_gemm_taps<T>(xb, rows, C_pad, 3, 1, w1, rows, D,
                                     Conv1Ep<T>{b1, y1, D, 2 * P, Tm, (size_t)rows * D}, s));
  QASR_TRY(launch_wgmma_gemm_taps<T>(y1, rows, D, 3, 2, w2, B * P, D,
                                     Conv2Ep<T>{b2, pos, out, D, P, t_out, Tp}, s));
  return 0;
}

}  // namespace

// mel (B, C0, Tm) float32; w1 (S, D, 3 C_pad) and w2 (S, D, 3 D) tap-major
// GEMM operands (S = 2 in f32: hi, lo), b1, b2 (D,) and pos (>= t_out, D)
// in the compute dtype; scratch xb (S, 2 B P, C_pad) and y1 (S, 2 B P, D);
// out (B, Tp, D).  P >= max(Tp, t_out + 1) is conv2's row pitch.
extern "C" int qasr_conv_stem(int dtype, const void* mel, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* pos, void* xb,
                              void* y1, void* out, int B, int C0, int C_pad, int Tm, int D,
                              int t_out, int Tp, int P, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return run_stem<float>((const float*)mel, (const float*)w1, (const float*)b1,
                           (const float*)w2, (const float*)b2, (const float*)pos, (float*)xb,
                           (float*)y1, (float*)out, B, C0, C_pad, Tm, D, t_out, Tp, P, s);
  using bf = __nv_bfloat16;
  return run_stem<bf>((const float*)mel, (const bf*)w1, (const bf*)b1, (const bf*)w2,
                      (const bf*)b2, (const bf*)pos, (bf*)xb, (bf*)y1, (bf*)out, B, C0, C_pad,
                      Tm, D, t_out, Tp, P, s);
}
