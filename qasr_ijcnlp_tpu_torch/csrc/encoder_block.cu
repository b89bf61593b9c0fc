// Fused encoder block: the attention half (K4) and the finish half (K5, K6).
//
// qasr_attention replaces qasr_ijcnlp_tpu/ops/encoder_block.py `_attn_kernel`:
// fp32 LN(x) -> Q/K/V projections (q, k scaled by dh^-0.25; the key has no
// bias) -> softmax(QK^T + mask for keys >= t_real) V.  Three launches: LN,
// one QKV GEMM against the concatenated (3D, D) weight, and the online-softmax
// attention core of attention.cuh (shared with K8), which never writes the
// (T, T) logits, at any head width dh = D / n_head up to 256 (the JAX gate
// sends heads of 64 and 128 here).  Bound on the H100: the attention core,
// 4 * B * H * t_real * Tp * dh FLOP on SIMT FMAs fed from shared memory;
// keys past t_real are skipped whole (their weight is exactly 0), which
// saves the 36 padded keys of every 1536-row tile.
//
// qasr_finish replaces `_finish_kernel` (K5, D <= 512) and
// `_finish_kernel_ftiled` (K6, D > 512): x + attn Wo + bo -> LN -> fc ->
// exact GELU -> proj -> + residual, as three GEMM launches with fused
// epilogues plus the shared LN kernel.  The GEMM tile does not depend on D,
// and proj sums all of F in fp32 before its one rounding, which is what K6's
// streamed fp32 accumulator does, so one kernel serves both.  Bound: the
// out-proj, fc and proj GEMMs (18 * B * Tp * D^2 FLOP) on SIMT fp32 FMAs.
#include "attention.cuh"

using namespace qasr;

namespace {

// QKV epilogue: column n of the fused (3D) output is segment n / D
// (0 = q, 1 = k, 2 = v).  q = (T(acc) + bq) * scale, k = T(acc) * scale,
// v = T(acc) + bv, each op rounded to T as in the reference.
template <typename T>
struct QkvEp {
  const T* bias;  // (3D,) [bq | 0 | bv]
  T* qkv;
  int D;
  float scale;  // dh^-0.25 already rounded to T by the caller
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    const int seg = n / D;
    float v = rnd<T>(acc);
    if (seg != 1) v = rnd<T>(v + to_f(bias[n]));
    if (seg != 2) v = rnd<T>(v * scale);
    qkv[(size_t)m * 3 * D + n] = from_f<T>(v);
  }
};

template <typename T>
int run_attention(const T* x, const float* g, const float* beta, const T* wqkv,
                  const T* bqkv, float scale, T* h, T* qkv, T* out, int B, int Tp, int D,
                  int n_head, int t_real, cudaStream_t s) {
  const int M = B * Tp;
  QASR_TRY(launch_layer_norm<T>(x, g, beta, h, M, D, s));
  QASR_TRY(launch_gemm(M, 3 * D, D, 1, RowMajor<T>{h, D}, WeightNK<T>{wqkv, D},
                       QkvEp<T>{bqkv, qkv, D, scale}, s));
  // q, k and v are the three D-wide column segments of each qkv row.
  const int dh = D / n_head;
  const Strides in = packed_strides(Tp, 3 * D, dh);
  const AttnArgs<T> a{qkv, qkv + D, qkv + 2 * D, out, in, in, in,
                      packed_strides(Tp, D, dh), Tp, Tp, t_real, dh};
  QASR_TRY((launch_attn_core<T, 1>(a, B, n_head, s)));
  return 0;
}

// r = x + (T(attn Wo) + bo)
template <typename T>
struct OutProjEp {
  const T* bo;
  const T* x;
  T* r;
  int D;
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    const size_t i = (size_t)m * D + n;
    r[i] = from_f<T>(to_f(x[i]) + rnd<T>(rnd<T>(acc) + to_f(bo[n])));
  }
};

// t = gelu(T(h Wf) + bf)
template <typename T>
struct FcEp {
  const T* bf;
  T* t;
  int F;
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    t[(size_t)m * F + n] = from_f<T>(gelu_erf(rnd<T>(rnd<T>(acc) + to_f(bf[n]))));
  }
};

// out = r + (T(t Wp) + bp)
template <typename T>
struct ProjEp {
  const T* bp;
  const T* r;
  T* out;
  int D;
  __device__ __forceinline__ void operator()(int, int m, int n, float acc) const {
    const size_t i = (size_t)m * D + n;
    out[i] = from_f<T>(to_f(r[i]) + rnd<T>(rnd<T>(acc) + to_f(bp[n])));
  }
};

template <typename T>
int run_finish(const T* x, const T* attn, const T* wo, const T* bo, const float* g,
               const float* beta, const T* wf, const T* bf, const T* wp, const T* bp,
               T* r, T* h, T* t, T* out, int M, int D, int F, cudaStream_t s) {
  QASR_TRY(launch_gemm(M, D, D, 1, RowMajor<T>{attn, D}, WeightNK<T>{wo, D},
                       OutProjEp<T>{bo, x, r, D}, s));
  QASR_TRY(launch_layer_norm<T>(r, g, beta, h, M, D, s));
  QASR_TRY(launch_gemm(M, F, D, 1, RowMajor<T>{h, D}, WeightNK<T>{wf, D},
                       FcEp<T>{bf, t, F}, s));
  QASR_TRY(launch_gemm(M, D, F, 1, RowMajor<T>{t, F}, WeightNK<T>{wp, F},
                       ProjEp<T>{bp, r, out, D}, s));
  return 0;
}

}  // namespace

// x (B, Tp, D); g, b (D,) float32; wqkv (3D, D) and bqkv (3D,) in the compute
// dtype; scratch h (B, Tp, D) and qkv (B, Tp, 3D); out (B, Tp, D).
extern "C" int qasr_attention(int dtype, const void* x, const void* g, const void* b,
                              const void* wqkv, const void* bqkv, float scale, void* h,
                              void* qkv, void* out, int B, int Tp, int D, int n_head,
                              int t_real, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return run_attention<float>((const float*)x, (const float*)g, (const float*)b,
                                (const float*)wqkv, (const float*)bqkv, scale, (float*)h,
                                (float*)qkv, (float*)out, B, Tp, D, n_head, t_real, s);
  using bf = __nv_bfloat16;
  return run_attention<bf>((const bf*)x, (const float*)g, (const float*)b, (const bf*)wqkv,
                           (const bf*)bqkv, scale, (bf*)h, (bf*)qkv, (bf*)out, B, Tp, D,
                           n_head, t_real, s);
}

// x, attn (M, D); wo (D, D), wf (F, D), wp (D, F) in nn.Linear layout and
// biases in the compute dtype; g, b (D,) float32; scratch r, h (M, D) and
// t (M, F); out (M, D).
extern "C" int qasr_finish(int dtype, const void* x, const void* attn, const void* wo,
                           const void* bo, const void* g, const void* b, const void* wf,
                           const void* bf_, const void* wp, const void* bp, void* r, void* h,
                           void* t, void* out, int M, int D, int F, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return run_finish<float>((const float*)x, (const float*)attn, (const float*)wo,
                             (const float*)bo, (const float*)g, (const float*)b,
                             (const float*)wf, (const float*)bf_, (const float*)wp,
                             (const float*)bp, (float*)r, (float*)h, (float*)t, (float*)out,
                             M, D, F, s);
  using bf = __nv_bfloat16;
  return run_finish<bf>((const bf*)x, (const bf*)attn, (const bf*)wo, (const bf*)bo,
                        (const float*)g, (const float*)b, (const bf*)wf, (const bf*)bf_,
                        (const bf*)wp, (const bf*)bp, (bf*)r, (bf*)h, (bf*)t, (bf*)out, M, D,
                        F, s);
}
