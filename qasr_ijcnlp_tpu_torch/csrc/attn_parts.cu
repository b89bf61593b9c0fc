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
// Each mode keeps the thread layout and tiles of K4's former SIMT attention
// core (attention.cuh: one block per 64 query rows of one head of one batch item,
// 32-key shared-memory tiles, four threads a row) and runs its own product
// loops (`tile_logits`, `tile_pv`), so the three times split the core's own
// costs.  The TPU kernel normalised p before PV, which needs
// the row's max and denominator first: `full` walks the keys twice (an
// online max and fp32 denominator, then the products with the normalised,
// rounded p), `softmax` once for the max and denominator and then reads the
// first 64 keys again.  The TPU grid ran its head pairs in order into one
// (B, Tp, 128) output block, so only heads 4-5 survived; blocks here run in
// parallel in no order, so every head writes its own columns of a (B, Tp, D)
// output.  Bound on the H100, by operations: dots 4 * B * H * Tp^2 * 64 and
// full 4 * B * H * Tp^2 * 64 plus its softmax at the bf16 tensor-core peak
// (the function needs one QK^T; the second pass here is this kernel's
// cost, not the function's), softmax four fp32 operations per (query, key)
// pair (product, max, exponential, sum) at the fp32 peak.  All three run on
// SIMT fp32 FMAs here, like the core.
#include "attention.cuh"

using namespace qasr;

namespace {

constexpr int PW = 64;  // head width of the diagnostic (the TPU script's dh)

enum Mode : int { kDots = 0, kSoftmax = 1, kFull = 2 };

using bf16 = __nv_bfloat16;

// Load a 32-key tile of k (and v) into shared memory.
__device__ __forceinline__ void load_kv(const bf16* kb, const bf16* vb, int ld, int k0,
                                        float* Ks, float* Vs, int tid) {
  for (int i = tid; i < AK * PW; i += ATHREADS) {
    const int rr = i / PW, c = i % PW;
    Ks[rr * (PW + 1) + c] = to_f(kb[(size_t)(k0 + rr) * ld + c]);
    if (Vs != nullptr) Vs[rr * PW + c] = to_f(vb[(size_t)(k0 + rr) * ld + c]);
  }
}

// Running max and fp32 denominator over a row, merged across its 4 threads.
__device__ __forceinline__ void online_update(const float s[8], float& m_run, float& l_run) {
  float mt = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) mt = fmaxf(mt, s[j]);
  mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
  mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
  const float m_new = fmaxf(m_run, mt);
  float ls = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ls += expf(s[j] - m_new);
  ls += __shfl_xor_sync(0xffffffffu, ls, 1);
  ls += __shfl_xor_sync(0xffffffffu, ls, 2);
  l_run = l_run * expf(m_run - m_new) + ls;
  m_run = m_new;
}

template <int kMode>
__global__ void __launch_bounds__(ATHREADS)
attn_parts_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int Tp, int D) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [AQ][PW + 1]
  float* Ks = Qs + AQ * (PW + 1);   // [AK][PW + 1]
  float* Vs = Ks + AK * (PW + 1);   // [AK][PW]
  float* Ps = Vs + AK * PW;         // [AQ][AK + 1]
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const size_t base = (size_t)b * Tp * D + (size_t)h * PW;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int n_tiles = Tp / AK;
  const int t = q0 + r;
  float* pr = Ps + r * (AK + 1);

  for (int i = tid; i < AQ * PW; i += ATHREADS) {
    const int rr = i / PW, c = i % PW;
    Qs[rr * (PW + 1) + c] = to_f(q[base + (size_t)(q0 + rr) * D + c]);
  }
  const float* qr = Qs + r * (PW + 1);

  if (kMode == kSoftmax) {
    // l_j = q[t, 0] * k[j, 0] in fp32: only column 0 of each key tile.
    float m_run = -INFINITY, l_run = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      __syncthreads();
      if (tid < AK) Ks[tid] = to_f(kb[(size_t)(kt * AK + tid) * D]);
      __syncthreads();
      float s[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = qr[0] * Ks[part * 8 + j];
      online_update(s, m_run, l_run);
    }
    __syncthreads();
    for (int j = tid; j < PW; j += ATHREADS) Ks[j] = to_f(kb[(size_t)j * D]);
    __syncthreads();
    bf16* orow = out + base + (size_t)t * D;
    for (int c = part; c < PW; c += 4)
      orow[c] = from_f<bf16>(expf(qr[0] * Ks[c] - m_run) / l_run);
    return;
  }

  float m_run = -INFINITY, l_run = 0.f;
  if (kMode == kFull) {  // pass 1: the row's max and fp32 denominator
    for (int kt = 0; kt < n_tiles; ++kt) {
      __syncthreads();
      load_kv(kb, nullptr, D, kt * AK, Ks, nullptr, tid);
      __syncthreads();
      float s[8];
      tile_logits<PW>(qr, Ks, part, s);
      online_update(s, m_run, l_run);
    }
  }
  float o[PW / 4];
#pragma unroll
  for (int c = 0; c < PW / 4; ++c) o[c] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();  // the previous tile's Ks, Vs and Ps consumed
    load_kv(kb, vb, D, kt * AK, Ks, Vs, tid);
    __syncthreads();
    float s[8];
    tile_logits<PW>(qr, Ks, part, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pr[part * 8 + j] = kMode == kFull ? rnd<bf16>(expf(s[j] - m_run) / l_run)
                                        : rnd<bf16>(s[j]);
    __syncthreads();
    tile_pv<PW>(pr, Vs, part, o);
  }
  bf16* orow = out + base + (size_t)t * D;
#pragma unroll
  for (int c = 0; c < PW / 4; ++c) orow[part + 4 * c] = from_f<bf16>(o[c]);
}

template <int kMode>
cudaError_t launch_parts(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B,
                         int Tp, int D, cudaStream_t s) {
  constexpr int smem = attn_smem_bytes(PW);
  const cudaError_t e = cudaFuncSetAttribute(
      attn_parts_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(Tp / AQ, D / PW, B);
  attn_parts_kernel<kMode><<<grid, ATHREADS, smem, s>>>(q, k, v, out, Tp, D);
  return cudaGetLastError();
}

}  // namespace

// q, k, v and out (B, Tp, D) bfloat16, row-major, D a multiple of 64 (heads
// of 64 at columns h * 64), Tp a multiple of 64; mode 0 dots, 1 softmax,
// 2 full.
extern "C" int qasr_attn_parts(int mode, const void* q, const void* k, const void* v,
                               void* out, int B, int Tp, int D, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
  bf16* o = (bf16*)out;
  if (mode == kDots) QASR_TRY(launch_parts<kDots>(qq, kk, vv, o, B, Tp, D, s));
  else if (mode == kSoftmax) QASR_TRY(launch_parts<kSoftmax>(qq, kk, vv, o, B, Tp, D, s));
  else if (mode == kFull) QASR_TRY(launch_parts<kFull>(qq, kk, vv, o, B, Tp, D, s));
  else return (int)cudaErrorInvalidValue;
  return 0;
}
