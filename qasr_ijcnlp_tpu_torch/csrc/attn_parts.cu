// The attention core's diagnostic split (K11): dots only, softmax only, or
// both, on bf16 (B, Tp, D) q/k/v with 64-wide heads, no mask and no scale.
//
// Replaces scripts/bench_attn_parts.py `kernel`, whose three modes split the
// fused encoder attention's time into its products and its softmax:
//
//   dots     p = bf16(fp32 q.k^T), no softmax;         out = bf16(p v)
//   softmax  l = fp32 q[:, 0] k[:, 0] (one product per pair, so no dot
//            product; the script's bf16 product is folded into its fp32
//            cast by XLA); p = bf16(softmax(l));       out = p[:, :64]
//   full     p = bf16(softmax(fp32 q.k^T)), normalised before PV;
//            out = bf16(p v)
//
// `dots` and `full` run on the tensor-core attention core that K4, K7 and
// K8 run (attention_tc.cuh: wgmma, a TMA ring, one producer warp), called
// as K8 calls it (packed heads, t_real = Tp, q and k unscaled), in its
// kTcDots and kTcFull modes, so full - dots is that core's softmax cost.
// `full` walks the key tiles twice (K alone for each row's max and fp32
// denominator, then K and V with the normalised p): the second QK^T is this
// kernel's cost, not the function's.  The TPU grid ran its head pairs in
// order into one (B, Tp, 128) output block, so only heads 4-5 survived;
// blocks here run in parallel in no order, so every head writes its own
// columns of a (B, Tp, D) output.
//
// `softmax` is its own SIMT kernel, bound by the special-function units:
// one block per 128 query rows of one head of one batch item stages the
// head's key column 0 (Tp values) in shared memory once; each thread owns
// one query row and walks all Tp keys twice, first for the row's max, then
// for one exponential per (query, key) pair (ex2.approx, log2 e folded into
// q), summed in fp32; the first 64 exponentials are kept in shared memory
// and written normalised and rounded, one warp per row.  No shortcut from
// the rank-1 logits: the mode stands for the softmax of a general logits
// row, so every pair's product, max, exponential and sum is computed.
//
// Bound on the H100 (diagnostics/attn_parts.py `work`, `bound_ms`): dots
// and full by operations, 4 B H Tp^2 64 FLOP at the bf16 tensor-core peak
// (and full's B H Tp^2 exponentials, below that); softmax by its B H Tp^2
// exponentials at 16 per SM per clock (compute capability 9.0), 4x its four
// fp32 operations per pair at the fp32 peak.
#include "attention_tc.cuh"

namespace qasr {

constexpr int PW = 64;        // head width of the diagnostic (the TPU script's dh)
constexpr int SM_ROWS = 128;  // softmax: query rows (threads) per block

enum PartsMode : int { kPartsDots = 0, kPartsSoftmax = 1, kPartsFull = 2 };

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Dynamic shared memory of the softmax block: the key column (Tp floats),
// then SM_ROWS rows of the first PW exponentials (PW + 1 floats a row, so
// a thread's row and a warp's columns read without bank conflicts), then
// each row's 1 / denominator.
inline int softmax_smem_bytes(int Tp) {
  return (int)sizeof(float) * (Tp + SM_ROWS * (PW + 1) + SM_ROWS);
}

__global__ void __launch_bounds__(SM_ROWS)
softmax_part_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    __nv_bfloat16* __restrict__ out, int Tp, int D) {
  extern __shared__ __align__(16) float sm[];
  float* kc = sm;                       // [Tp] key column 0 of this head
  float* pe = kc + Tp;                  // [SM_ROWS][PW + 1] exponentials of keys 0..63
  float* inv = pe + SM_ROWS * (PW + 1); // [SM_ROWS] 1 / denominator
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int row0 = blockIdx.x * SM_ROWS, t = row0 + tid;
  const size_t base = (size_t)b * Tp * D + (size_t)h * PW;
  // the key column, loads issued four at a time (one strided 2-byte load each)
  for (int j0 = 0; j0 < Tp; j0 += 4 * SM_ROWS) {
    __nv_bfloat16 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * SM_ROWS + tid;
      x[u] = j < Tp ? k[base + (size_t)j * D] : __float2bfloat16(0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u * SM_ROWS + tid < Tp) kc[j0 + u * SM_ROWS + tid] = to_f(x[u]);
  }
  constexpr float kLog2e = 1.4426950408889634f;
  const float qs = t < Tp ? to_f(q[base + (size_t)t * D]) * kLog2e : 0.f;
  __syncthreads();

  // the row's max of the (log2-scaled) logits, two chains
  const float4* kc4 = reinterpret_cast<const float4*>(kc);
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll 4
  for (int j = 0; j < Tp / 4; ++j) {
    const float4 x = kc4[j];
    m0 = fmaxf(m0, fmaxf(qs * x.x, qs * x.y));
    m1 = fmaxf(m1, fmaxf(qs * x.z, qs * x.w));
  }
  const float m = fmaxf(m0, m1);
  // one exponential per pair, four partial sums; keys 0..63 kept
  float l[4] = {0.f, 0.f, 0.f, 0.f};
  float* per = pe + tid * (PW + 1);
#pragma unroll
  for (int j = 0; j < PW / 4; ++j) {
    const float4 x = kc4[j];
    const float e[4] = {ex2_approx(fmaf(qs, x.x, -m)), ex2_approx(fmaf(qs, x.y, -m)),
                        ex2_approx(fmaf(qs, x.z, -m)), ex2_approx(fmaf(qs, x.w, -m))};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      l[c] += e[c];
      per[4 * j + c] = e[c];
    }
  }
#pragma unroll 4
  for (int j = PW / 4; j < Tp / 4; ++j) {
    const float4 x = kc4[j];
    l[0] += ex2_approx(fmaf(qs, x.x, -m));
    l[1] += ex2_approx(fmaf(qs, x.y, -m));
    l[2] += ex2_approx(fmaf(qs, x.z, -m));
    l[3] += ex2_approx(fmaf(qs, x.w, -m));
  }
  inv[tid] = 1.f / ((l[0] + l[1]) + (l[2] + l[3]));
  __syncthreads();

  // p = bf16(e / l) for keys 0..63: one warp per row, two columns a lane
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < SM_ROWS && row0 + r < Tp; r += SM_ROWS / 32) {
    const float* pr = pe + r * (PW + 1);
    const float il = inv[r];
    *reinterpret_cast<__nv_bfloat162*>(out + base + (size_t)(row0 + r) * D + 2 * lane) =
        __floats2bfloat162_rn(pr[2 * lane] * il, pr[2 * lane + 1] * il);
  }
}

inline cudaError_t launch_softmax_part(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       __nv_bfloat16* out, int B, int Tp, int D,
                                       cudaStream_t s) {
  const int smem = softmax_smem_bytes(Tp);
  const cudaError_t e = cudaFuncSetAttribute(
      softmax_part_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tp + SM_ROWS - 1) / SM_ROWS, D / PW, B);
  softmax_part_kernel<<<grid, SM_ROWS, smem, s>>>(q, k, out, Tp, D);
  return cudaGetLastError();
}

}  // namespace qasr

using namespace qasr;

// q, k, v and out (B, Tp, D) bfloat16, row-major, 16-byte aligned, D a
// multiple of 64 (heads of 64 at columns h * 64), Tp a multiple of 64;
// mode 0 dots, 1 softmax, 2 full.
extern "C" int qasr_attn_parts(int mode, const void* q, const void* k, const void* v,
                               void* out, int B, int Tp, int D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Tp < PW || Tp % PW || D % PW) return (int)cudaErrorInvalidValue;
  if (mode == kPartsSoftmax)
    return (int)launch_softmax_part((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                    (__nv_bfloat16*)out, B, Tp, D, s);
  const long long sq = (long long)Tp * D;
  const TcArgs a{TcOperand{q, sq, PW, D}, TcOperand{k, sq, PW, D}, TcOperand{v, sq, PW, D},
                 out, sq, PW, D, Tp, Tp, PW, 0};
  if (mode == kPartsDots)
    return (int)launch_attn_tc_width<__nv_bfloat16, PW, false, kTcDots>(a, B, D / PW, s);
  if (mode == kPartsFull)
    return (int)launch_attn_tc_width<__nv_bfloat16, PW, false, kTcFull>(a, B, D / PW, s);
  return (int)cudaErrorInvalidValue;
}
