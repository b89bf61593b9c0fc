// Fused decoder-layer step (K10): one launch per decoder layer per token.
//
// Replaces qasr_ijcnlp_tpu/ops/decoder_step.py `_kernel`.  For B rows of one
// token each: LN -> q/k/v (the fresh k/v written into the self cache at idx)
// -> self-attention over positions 0..idx -> out-proj + residual -> cross
// LN -> q -> cross-attention over the Ta audio positions -> out-proj +
// residual -> LN -> fc -> exact-erf GELU -> proj + residual.  Numerics are
// the reference kernel's: fp32 LN and softmax, every product's inputs in the
// compute dtype T summed in fp32, each product's output rounded to T where
// the reference rounds it, the softmax denominator over the unrounded p and
// PV over p rounded to T.  The self q is scaled by 64^-0.5 against the
// unscaled self K; the cross K arrives pre-scaled by 64^-0.25 (rounded to
// T), so the cross q is scaled by 64^-0.25.
//
// The TPU kernel's grid was (B / 8 batch tiles) x (sequential cache chunks);
// on 132 SMs that would be 2 blocks at B = 16, each streaming every weight
// and its rows' whole cross cache.  Here one cooperative launch spreads each
// phase over every block, with a grid-wide barrier between phases: the
// products split their output columns (one column per warp, 8 batch rows
// per tile, the tile's input staged in shared memory with its LayerNorm
// applied), the attentions split the (row, head) pairs (one block each, the
// logits of all positions in shared memory).  Bound on the H100: the bytes
// of the layer's weights (14 D^2 values), the cross K/V (2 B Ta D values)
// and the self cache, read once: 86 MB at tiny, B = 16, f32.
#include <algorithm>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace qasr {

constexpr int DS_THREADS = 256;
constexpr int DS_WARPS = DS_THREADS / 32;
constexpr int DS_RB = 8;  // batch rows per product tile: one per warp for its LN
constexpr int DS_DH = 64;

template <typename T>
struct StepArgs {
  const T* x;        // (B, D)
  const T* w;        // packed weights and biases (ops/decoder_step.py _offsets)
  const float* ln;   // (6, D): attn_ln, cross_attn_ln, mlp_ln weight and bias
  T* self_k;         // (B, H, ctx, 64), written at idx
  T* self_v;
  const T* cross_k;  // (B, H, Ta, 64), pre-scaled by 64^-0.25
  const T* cross_v;
  T* out;            // (B, D)
  float* work;       // B (6 D + 4 D) floats of phase outputs
  int B, D, H, ctx, Ta, idx;
};

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < DS_WARPS; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < DS_WARPS; ++i) r += red[i];
  __syncthreads();
  return r;
}

// Product tile input: rows b0 .. b0 + 7 of src (B, D) through an fp32
// LayerNorm, rounded to T; warp r normalises row b0 + r.
template <typename T, typename S>
struct LnFill {
  const S* src;
  const float* g;
  const float* b;
  int D;
  __device__ void operator()(int b0, float* As) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const S* xr = src + (size_t)(b0 + warp) * D;
    float s = 0.f;
    for (int k = lane; k < D; k += 32) s += to_f(xr[k]);
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float d = to_f(xr[k]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + 1e-5f);
    for (int k = lane; k < D; k += 32)
      As[warp * D + k] = rnd<T>((to_f(xr[k]) - mean) * rstd * g[k] + b[k]);
  }
};

// Product tile input: rows b0 .. b0 + 7 of a phase output (B, K) as stored.
struct RowFill {
  const float* src;
  int K;
  __device__ void operator()(int b0, float* As) const {
    const float* s = src + (size_t)b0 * K;
    for (int i = threadIdx.x; i < DS_RB * K; i += DS_THREADS) As[i] = s[i];
  }
};

// out(b, n) = ep(b, n, sum_k A[b, k] W[n, k]) for every row b and column n;
// W is (N, K) row-major in T.  Units of (8 rows, 8 columns) go round the
// grid; each warp sums one column for the 8 rows over lane-strided k.
template <typename T, class Fill, class Ep>
__device__ void product_phase(int B, int N, int K, const T* __restrict__ W, Fill fill, Ep ep,
                              float* As) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ncb = (N + DS_WARPS - 1) / DS_WARPS;
  const int units = (B / DS_RB) * ncb;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int b0 = (u / ncb) * DS_RB, n = (u % ncb) * DS_WARPS + warp;
    __syncthreads();  // the previous unit is done with As
    fill(b0, As);
    __syncthreads();
    if (n < N) {
      const T* wr = W + (size_t)n * K;
      float acc[DS_RB];
#pragma unroll
      for (int r = 0; r < DS_RB; ++r) acc[r] = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float wv = to_f(wr[k]);
#pragma unroll
        for (int r = 0; r < DS_RB; ++r) acc[r] = fmaf(As[r * K + k], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < DS_RB; ++r) {
        const float total = warp_sum(acc[r]);
        if (lane == r) ep(b0 + r, n, total);
      }
    }
  }
}

// dst[b, h 64 + d] = softmax_t(q . K[b, h, t]) V[b, h, t, d] over t < t_vis,
// rounded to T; q (B, D) fp32 holding T values; K/V (B, H, T_len, 64).  One
// block per (b, h): thread t-strided logits into shared memory, block-wide
// max and sum, then PV by (4 position slices) x (64 columns).
template <typename T>
__device__ void attention_phase(int B, int H, const float* q, const T* K, const T* V,
                                int T_len, int t_vis, float* dst, float* sm) {
  const int D = H * DS_DH, tid = threadIdx.x;
  float* qv = sm;          // [64]
  float* part = sm + 64;   // [4][64]
  float* red = part + 256; // [16]
  float* lg = red + 16;    // [t_vis]
  for (int it = blockIdx.x; it < B * H; it += gridDim.x) {
    const int b = it / H, h = it % H;
    const T* kb = K + (size_t)it * T_len * DS_DH;
    const T* vb = V + (size_t)it * T_len * DS_DH;
    __syncthreads();  // the previous item is done with qv, part and lg
    if (tid < DS_DH) qv[tid] = q[(size_t)b * D + h * DS_DH + tid];
    __syncthreads();
    float m = -INFINITY;
    for (int t = tid; t < t_vis; t += DS_THREADS) {
      const T* kr = kb + (size_t)t * DS_DH;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < DS_DH; ++d) s = fmaf(qv[d], to_f(kr[d]), s);
      lg[t] = s;
      m = fmaxf(m, s);
    }
    m = block_max(m, red);
    float s = 0.f;
    for (int t = tid; t < t_vis; t += DS_THREADS) {
      const float p = expf(lg[t] - m);
      s += p;
      lg[t] = rnd<T>(p);
    }
    s = block_sum(s, red);  // its barriers also publish the rounded p
    const int slice = tid >> 6, d = tid & 63;
    float acc = 0.f;
    for (int t = slice; t < t_vis; t += 4)
      acc = fmaf(lg[t], to_f(vb[(size_t)t * DS_DH + d]), acc);
    part[slice * DS_DH + d] = acc;
    __syncthreads();
    if (tid < DS_DH)
      dst[(size_t)b * D + h * DS_DH + tid] =
          rnd<T>((part[tid] + part[64 + tid] + part[128 + tid] + part[192 + tid]) / s);
  }
}

template <typename T>
__global__ void __launch_bounds__(DS_THREADS, 2) decoder_layer_kernel(const StepArgs<T> a) {
  extern __shared__ float sm[];
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, D = a.D, F = 4 * D, H = a.H;
  const size_t BD = (size_t)B * D, DD = (size_t)D * D, FD = (size_t)F * D;
  // Phase outputs in fp32 (values already rounded to T).  None of these, nor
  // the self cache, is read in a phase before the barrier after its writes.
  float* qs = a.work;
  float* attn = qs + BD;
  float* xmid = attn + BD;
  float* qc = xmid + BD;
  float* ca = qc + BD;
  float* x2 = ca + BD;
  float* tt = x2 + BD;  // (B, F)
  const T* wqkv = a.w;
  const T* wo = a.w + 3 * DD;
  const T* wcq = a.w + 4 * DD;
  const T* wco = a.w + 5 * DD;
  const T* wf = a.w + 6 * DD;
  const T* wp = wf + FD;
  const T* bqkv = wp + FD;
  const T* bo = bqkv + 3 * D;
  const T* bcq = bo + D;
  const T* bco = bcq + D;
  const T* bf = bco + D;
  const T* bp = bf + F;
  const float* ln = a.ln;

  // 1. LN + q/k/v; the fresh k and v go into the self cache at idx.
  product_phase<T>(B, 3 * D, D, wqkv, LnFill<T, T>{a.x, ln, ln + D, D},
                   [&](int b, int n, float acc) {
                     const float y = acc + to_f(bqkv[n]);
                     if (n < D) {
                       qs[(size_t)b * D + n] = rnd<T>(y * 0.125f);  // 64^-0.5
                       return;
                     }
                     const int c = n % D, h = c / DS_DH, d = c % DS_DH;
                     T* cache = n < 2 * D ? a.self_k : a.self_v;
                     cache[(((size_t)b * H + h) * a.ctx + a.idx) * DS_DH + d] = from_f<T>(y);
                   }, sm);
  grid.sync();
  // 2. self-attention over positions 0..idx
  attention_phase<T>(B, H, qs, a.self_k, a.self_v, a.ctx, a.idx + 1, attn, sm);
  grid.sync();
  // 3. out-proj + residual
  product_phase<T>(B, D, D, wo, RowFill{attn, D}, [&](int b, int n, float acc) {
    const size_t i = (size_t)b * D + n;
    xmid[i] = rnd<T>(to_f(a.x[i]) + rnd<T>(acc + to_f(bo[n])));
  }, sm);
  grid.sync();
  // 4. cross LN + q
  product_phase<T>(B, D, D, wcq, LnFill<T, float>{xmid, ln + 2 * D, ln + 3 * D, D},
                   [&](int b, int n, float acc) {
                     qc[(size_t)b * D + n] =
                         rnd<T>((acc + to_f(bcq[n])) * 0.35355339059327373f);  // 64^-0.25
                   }, sm);
  grid.sync();
  // 5. cross-attention over the Ta audio positions
  attention_phase<T>(B, H, qc, a.cross_k, a.cross_v, a.Ta, a.Ta, ca, sm);
  grid.sync();
  // 6. out-proj + residual
  product_phase<T>(B, D, D, wco, RowFill{ca, D}, [&](int b, int n, float acc) {
    const size_t i = (size_t)b * D + n;
    x2[i] = rnd<T>(xmid[i] + rnd<T>(acc + to_f(bco[n])));
  }, sm);
  grid.sync();
  // 7. LN + fc + GELU
  product_phase<T>(B, F, D, wf, LnFill<T, float>{x2, ln + 4 * D, ln + 5 * D, D},
                   [&](int b, int n, float acc) {
                     tt[(size_t)b * F + n] = rnd<T>(gelu_erf(acc + to_f(bf[n])));
                   }, sm);
  grid.sync();
  // 8. proj + residual
  product_phase<T>(B, D, F, wp, RowFill{tt, F}, [&](int b, int n, float acc) {
    const size_t i = (size_t)b * D + n;
    a.out[i] = from_f<T>(x2[i] + rnd<T>(acc + to_f(bp[n])));
  }, sm);
}

template <typename T>
int run_layer_step(const StepArgs<T>& args, cudaStream_t s) {
  const int smem =
      4 * std::max(DS_RB * 4 * args.D, 64 + 256 + 16 + std::max(args.ctx, args.Ta));
  auto kern = decoder_layer_kernel<T>;
  QASR_TRY(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  int dev = 0, sms = 0, per_sm = 0;
  QASR_TRY(cudaGetDevice(&dev));
  QASR_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  QASR_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, DS_THREADS, smem));
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  StepArgs<T> a = args;
  void* params[] = {&a};
  QASR_TRY(cudaLaunchCooperativeKernel((const void*)kern, dim3(sms * std::min(per_sm, 2)),
                                       dim3(DS_THREADS), params, smem, s));
  return (int)cudaGetLastError();
}

}  // namespace qasr

using namespace qasr;

// x, out (B, D), packed weights, self K/V (B, H, ctx, 64) and cross K/V
// (B, H, Ta, 64) in the compute dtype; ln (6, D) and work (B, 10 D) fp32.
// B % 8 == 0, D = 64 H, 0 <= idx < ctx.
extern "C" int qasr_decoder_layer_step(int dtype, const void* x, const void* w,
                                       const void* ln, void* self_k, void* self_v,
                                       const void* cross_k, const void* cross_v, void* out,
                                       void* work, int B, int D, int H, int ctx, int Ta,
                                       int idx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return run_layer_step<float>(
        {(const float*)x, (const float*)w, (const float*)ln, (float*)self_k, (float*)self_v,
         (const float*)cross_k, (const float*)cross_v, (float*)out, (float*)work, B, D, H,
         ctx, Ta, idx},
        s);
  using bf = __nv_bfloat16;
  return run_layer_step<bf>({(const bf*)x, (const bf*)w, (const float*)ln, (bf*)self_k,
                             (bf*)self_v, (const bf*)cross_k, (const bf*)cross_v, (bf*)out,
                             (float*)work, B, D, H, ctx, Ta, idx},
                            s);
}
