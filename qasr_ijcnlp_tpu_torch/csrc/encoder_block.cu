// Fused encoder block: the attention half (K4) and the finish half (K5, K6).
//
// qasr_attention replaces qasr_ijcnlp_tpu/ops/encoder_block.py `_attn_kernel`:
// fp32 LN(x) -> Q/K/V projections (q, k scaled by dh^-0.25; the key has no
// bias) -> softmax(QK^T + mask for keys >= t_real) V.  Three launches: LN,
// one QKV GEMM (gemm_tc.cuh) against the concatenated (3D, D) weight, and
// the attention core of attention_tc.cuh (shared with K7 and K8) with the
// denominator summing the rounded p, K4's rule.  The core reads q, k and v
// as the three Dl-wide column segments of each (B, Tp, 3 Dl) qkv row and
// never writes the (T, T) logits; key tiles past t_real are never loaded.
// Heads of 64 and 128, the widths the JAX gate sends here.  Dl = n_head dh is
// the width of the heads the weights hold: D for the whole model, D / tp for
// a tensor-parallel rank's head shard (the JAX kernel's (D, Dl) weight
// columns, parallel/sharded.py): the QKV GEMM is then N = 3 Dl over K = D and
// the output (B, Tp, Dl).  Bound on the H100: the QKV product (6 B Tp D Dl
// FLOP) and the attention (4 B H t_real^2 dh) on the tensor cores, i.e.
// operations.
//
// qasr_finish replaces `_finish_kernel` (K5, D <= 512) and
// `_finish_kernel_ftiled` (K6, D > 512): x + attn Wo + bo -> LN -> fc ->
// exact GELU -> proj -> + residual, as three GEMM launches with fused
// epilogues plus the LN kernel.  The GEMM tile does not depend on D, and
// proj sums all of F in fp32 before its one rounding, which is what K6's
// streamed fp32 accumulator does, so one kernel serves both.  The GELU
// intermediate t (B, Tp, 4D) goes through device memory: at D = 1024 a
// 64-row proj accumulator over all D columns would be 256 KB, over a
// warpgroup's registers, and fusing fc into proj per row tile would
// recompute the fc product once per column split.  Bound: the out-proj, fc
// and proj products (18 B Tp D^2 FLOP) on the tensor cores.
//
// In f32 the GEMMs are 3xTF32 and read every operand as hi/lo slabs: the
// weights come split from the wrapper's packs, LN writes h split, the fc
// epilogue writes t split, and split_kernel splits the attention output
// before the out-projection.  Every rounding to the compute dtype stays
// where the reference has it (each product, bias add, scale and residual),
// so bf16 stays at the ulp level of the plain version.
#include "attention_tc.cuh"
#include "gemm_tc.cuh"

using namespace qasr;

namespace {

// fp32 LayerNorm over the last dim, one warp per row; the output is rounded
// to T (the reference computes LN in fp32 and casts back to the activation
// dtype) and stored as a GEMM A operand (f32: hi/lo slabs of rows x D).
template <typename T>
__global__ void layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                                  const float* __restrict__ beta, T* __restrict__ y, int rows,
                                  int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s += to_f(xr[i]);
  const float mean = warp_sum(s) / D;
  float v = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = to_f(xr[i]) - mean;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / D + 1e-5f);
  for (int i = lane; i < D; i += 32)
    store_operand(y, (size_t)row * D + i, (size_t)rows * D,
                  (to_f(xr[i]) - mean) * rstd * g[i] + beta[i]);
}

template <typename T>
cudaError_t launch_layer_norm(const T* x, const float* g, const float* b, T* y, int rows, int D,
                              cudaStream_t s) {
  const int warps_per_block = 8;
  const int blocks = (rows + warps_per_block - 1) / warps_per_block;
  layer_norm_kernel<T><<<blocks, warps_per_block * 32, 0, s>>>(x, g, b, y, rows, D);
  return cudaGetLastError();
}

// f32 hi/lo slabs of x (n values) for the out-projection's 3xTF32 A operand.
__global__ void split_kernel(const float* __restrict__ x, float* __restrict__ y, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    store_operand(y, i, n, x[i]);
}

// QKV epilogue: column n of the fused (3 Dl) output is segment n / Dl
// (0 = q, 1 = k, 2 = v), constant over a 128-column tile since Dl % 128 ==
// 0.  q = (T(acc) + bq) * scale, k = T(acc) * scale, v = T(acc) + bv, each op
// rounded to T as in the reference.
template <typename T>
struct QkvEp {
  const T* bias;  // (3 Dl,) [bq | 0 | bv]
  T* qkv;
  int D;  // Dl, the width of one segment
  float scale;  // dh^-0.25 already rounded to T by the caller
  __device__ __forceinline__ void operator()(int m, int n, float a0, float a1) const {
    const int seg = n / D;
    float v0 = rnd<T>(a0), v1 = rnd<T>(a1);
    if (seg != 1) {
      const float2 b = load2(bias + n);
      v0 = rnd<T>(v0 + b.x);
      v1 = rnd<T>(v1 + b.y);
    }
    if (seg != 2) {
      v0 = rnd<T>(v0 * scale);
      v1 = rnd<T>(v1 * scale);
    }
    store2(qkv + (size_t)m * 3 * D + n, v0, v1);
  }
};

// r = x + (T(attn Wo) + bo)
template <typename T>
struct OutProjEp {
  const T* bo;
  const T* x;
  T* r;
  int D;
  __device__ __forceinline__ void operator()(int m, int n, float a0, float a1) const {
    const size_t i = (size_t)m * D + n;
    const float2 b = load2(bo + n), xi = load2(x + i);
    store2(r + i, xi.x + rnd<T>(rnd<T>(a0) + b.x), xi.y + rnd<T>(rnd<T>(a1) + b.y));
  }
};

// t = gelu(T(h Wf) + bf), stored as proj's A operand (f32: hi/lo slabs of
// M x F)
template <typename T>
struct FcEp {
  const T* bf;
  T* t;
  int F;
  size_t slab;  // M F
  __device__ __forceinline__ void operator()(int m, int n, float a0, float a1) const {
    const size_t i = (size_t)m * F + n;
    const float2 b = load2(bf + n);
    store_operand(t, i, slab, gelu_erf(rnd<T>(rnd<T>(a0) + b.x)));
    store_operand(t, i + 1, slab, gelu_erf(rnd<T>(rnd<T>(a1) + b.y)));
  }
};

// out = r + (T(t Wp) + bp)
template <typename T>
struct ProjEp {
  const T* bp;
  const T* r;
  T* out;
  int D;
  __device__ __forceinline__ void operator()(int m, int n, float a0, float a1) const {
    const size_t i = (size_t)m * D + n;
    const float2 b = load2(bp + n), ri = load2(r + i);
    store2(out + i, ri.x + rnd<T>(rnd<T>(a0) + b.x), ri.y + rnd<T>(rnd<T>(a1) + b.y));
  }
};

template <typename T>
int run_attention(const T* x, const float* g, const float* beta, const T* wqkv,
                  const T* bqkv, float scale, T* h, T* qkv, T* out, int B, int Tp, int D,
                  int Dl, int n_head, int t_real, cudaStream_t s) {
  const int M = B * Tp, dh = n_head > 0 ? Dl / n_head : 0;
  if ((dh != 64 && dh != 128) || dh * n_head != Dl || Dl % GemmCfg<T>::BN || Dl > D)
    return (int)cudaErrorInvalidValue;
  QASR_TRY(launch_layer_norm<T>(x, g, beta, h, M, D, s));
  QASR_TRY(launch_wgmma_gemm<T>(h, wqkv, M, 3 * Dl, D, QkvEp<T>{bqkv, qkv, Dl, scale}, s));
  // q, k and v are the three Dl-wide column segments of each qkv row.
  const long long row = 3LL * Dl, batch = (long long)Tp * row;
  const TcArgs a{TcOperand{qkv, batch, dh, row}, TcOperand{qkv + Dl, batch, dh, row},
                 TcOperand{qkv + 2 * Dl, batch, dh, row}, out, (long long)Tp * Dl, dh, Dl,
                 Tp, t_real, dh, 0};
  if (dh == 64) return (int)launch_attn_tc_width<T, 64, true>(a, B, n_head, s);
  return (int)launch_attn_tc_width<T, 128, true>(a, B, n_head, s);
}

template <typename T>
int run_finish(const T* x, const T* attn, T* asplit, const T* wo, const T* bo, const float* g,
               const float* beta, const T* wf, const T* bf, const T* wp, const T* bp, T* r,
               T* h, T* t, T* out, int M, int D, int F, cudaStream_t s) {
  const T* a = attn;
  if constexpr (std::is_same<T, float>::value) {
    split_kernel<<<1024, 256, 0, s>>>(attn, asplit, (size_t)M * D);
    QASR_TRY(cudaGetLastError());
    a = asplit;
  }
  QASR_TRY(launch_wgmma_gemm<T>(a, wo, M, D, D, OutProjEp<T>{bo, x, r, D}, s));
  QASR_TRY(launch_layer_norm<T>(r, g, beta, h, M, D, s));
  QASR_TRY(launch_wgmma_gemm<T>(h, wf, M, F, D, FcEp<T>{bf, t, F, (size_t)M * F}, s));
  QASR_TRY(launch_wgmma_gemm<T>(t, wp, M, D, F, ProjEp<T>{bp, r, out, D}, s));
  return 0;
}

}  // namespace

// x (B, Tp, D); g, b (D,) float32; wqkv (S, 3 Dl, D) and bqkv (3 Dl,) in the
// compute dtype; scratch h (S, B Tp, D) and qkv (B, Tp, 3 Dl); out (B, Tp,
// Dl), Dl = n_head dh (D, or a head shard's width).  S = 2 in f32 (the hi and
// lo slabs), 1 in bf16.
extern "C" int qasr_attention(int dtype, const void* x, const void* g, const void* b,
                              const void* wqkv, const void* bqkv, float scale, void* h,
                              void* qkv, void* out, int B, int Tp, int D, int Dl, int n_head,
                              int t_real, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return run_attention<float>((const float*)x, (const float*)g, (const float*)b,
                                (const float*)wqkv, (const float*)bqkv, scale, (float*)h,
                                (float*)qkv, (float*)out, B, Tp, D, Dl, n_head, t_real, s);
  using bf = __nv_bfloat16;
  return run_attention<bf>((const bf*)x, (const float*)g, (const float*)b, (const bf*)wqkv,
                           (const bf*)bqkv, scale, (bf*)h, (bf*)qkv, (bf*)out, B, Tp, D, Dl,
                           n_head, t_real, s);
}

// x, attn (M, D); wo (S, D, D), wf (S, F, D), wp (S, D, F) in nn.Linear
// layout and biases in the compute dtype; g, b (D,) float32; scratch asplit
// (S, M, D; f32 only, else unused), r (M, D), h (S, M, D) and t (S, M, F);
// out (M, D).  S = 2 in f32, 1 in bf16.
extern "C" int qasr_finish(int dtype, const void* x, const void* attn, void* asplit,
                           const void* wo, const void* bo, const void* g, const void* b,
                           const void* wf, const void* bf_, const void* wp, const void* bp,
                           void* r, void* h, void* t, void* out, int M, int D, int F,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return run_finish<float>((const float*)x, (const float*)attn, (float*)asplit,
                             (const float*)wo, (const float*)bo, (const float*)g,
                             (const float*)b, (const float*)wf, (const float*)bf_,
                             (const float*)wp, (const float*)bp, (float*)r, (float*)h,
                             (float*)t, (float*)out, M, D, F, s);
  using bf = __nv_bfloat16;
  return run_finish<bf>((const bf*)x, (const bf*)attn, (bf*)asplit, (const bf*)wo,
                        (const bf*)bo, (const float*)g, (const float*)b, (const bf*)wf,
                        (const bf*)bf_, (const bf*)wp, (const bf*)bp, (bf*)r, (bf*)h, (bf*)t,
                        (bf*)out, M, D, F, s);
}

// One of the block's four products alone, for its tests and its timing
// beside torch.matmul: out = ep(a W^T) with epilogue 0 (QKV: N = 3D, bias
// [bq | 0 | bv], `scale` the rounded dh^-0.25), 1 (out-projection: res is
// x), 2 (fc: out is t, as hi/lo slabs (2, M, N) in f32) or 3 (proj: res is
// r).  a (S, M, K) and w (S, N, K) are GEMM operands (S = 2 in f32: hi, lo);
// bias (N,) and res, out (M, N) in the compute dtype.
extern "C" int qasr_block_gemm(int dtype, int epilogue, const void* a, const void* w,
                               const void* bias, const void* res, void* out, int M, int N,
                               int K, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const auto run = [&](auto tag) -> int {
    using T = decltype(tag);
    const T *pa = (const T*)a, *pw = (const T*)w, *pb = (const T*)bias, *pr = (const T*)res;
    T* po = (T*)out;
    switch (epilogue) {
      case 0:
        if (N % 3 || (N / 3) % GemmCfg<T>::BN) return (int)cudaErrorInvalidValue;
        return (int)launch_wgmma_gemm<T>(pa, pw, M, N, K, QkvEp<T>{pb, po, N / 3, scale}, s);
      case 1:
        return (int)launch_wgmma_gemm<T>(pa, pw, M, N, K, OutProjEp<T>{pb, pr, po, N}, s);
      case 2:
        return (int)launch_wgmma_gemm<T>(pa, pw, M, N, K, FcEp<T>{pb, po, N, (size_t)M * N}, s);
      case 3:
        return (int)launch_wgmma_gemm<T>(pa, pw, M, N, K, ProjEp<T>{pb, pr, po, N}, s);
    }
    return (int)cudaErrorInvalidValue;
  };
  return dtype == kF32 ? run(float()) : run(__nv_bfloat16());
}
