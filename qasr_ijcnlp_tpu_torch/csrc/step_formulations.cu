// The decode step's cross-attention in four formulations (K12): one query
// row per batch item over its own (Ta, D) K/V cache, six heads of 64, bf16
// inputs, no scale and no mask.
//
// Replaces scripts/bench_step_formulations.py, whose four Pallas bodies
// measured on the TPU which compute layout a fused decoder step should use:
//
//   dma    `_dma_kernel` (:38): out = q 1e-30 + sum_t k + sum_t v in fp32,
//          k, v (B, Ta, D): the read floor, every byte read and reduced once
//   vpu    `_vpu_kernel` (:61): per row and head softmax(q . k^T) v, all fp32,
//          k, v (B, D, Ta) "T-on-lanes": CUDA-core FMAs, online softmax over
//          chunks of t
//   mxu_t  `_mxu_t_kernel` (:95): the same on the tensor cores, row by row:
//          q expanded block-diagonally into a 16-row tile (rows 0..5 used),
//          logits (16, chunk) by WMMA bf16 16x16x16 with fp32 accumulation,
//          p rounded to bf16 for PV and for the sum, PV on the tensor cores
//   mxu_r  `_mxu_r_kernel` (:138): row-major k, v (B, Ta, D): the
//          block-diagonal q columns of 8 rows (48 of them) against an (8
//          rows x 16 positions, D) tile, the cross-row products computed and
//          masked, the online max and fp32 sum per (row, head) column, p
//          rounded to bf16 for PV; of the (48, D) PV product only the
//          head-diagonal slices are kept.  The TPU body wrote its raw,
//          unnormalised accumulator rows ("here just dump raw acc"); this
//          kernel writes the normalised attention.
//
// On the TPU a grid step carried the online softmax to the next chunk in
// scratch.  Here each block takes one split of t (and, for vpu, one head),
// keeps its own online (max, sum, accumulator) over its chunks, and writes
// them to scratch; a second kernel merges the splits and divides.  Every
// mode reads 2 B Ta D bf16 bytes of K and V (151 MB at B = 64, Ta = 1536:
// 45 us at 3.35 TB/s) for 4 B Ta D operations, so all four are bound by
// bytes; the loads are 16 bytes a thread, neighbouring threads on
// neighbouring addresses.  Simple versions: no TMA, no wgmma, no pipelining
// of the loads with the products.
#include <mma.h>

#include "common.cuh"

namespace qasr {

using bf16 = __nv_bfloat16;

constexpr int SF_D = 384, SF_H = 6, SF_DH = 64;
enum SfMode : int { kSfDma = 0, kSfVpu = 1, kSfMxuT = 2, kSfMxuR = 3 };

// Eight bf16 values of one 16-byte word as floats.
__device__ __forceinline__ void bf16x8(const uint4 w, float f[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// ---------------------------------------------------------------------------
// dma: block (split, b) sums DMA_ROWS positions of k and v; 384 threads,
// 48 column groups of 8 times 8 row lanes.
// ---------------------------------------------------------------------------
constexpr int DMA_ROWS = 128, DMA_THREADS = 384;

__global__ void __launch_bounds__(DMA_THREADS)
sf_dma_partial(const bf16* __restrict__ k, const bf16* __restrict__ v,
               float* __restrict__ part, int Ta, int S) {
  __shared__ float red[8][SF_D];
  const int s = blockIdx.x, b = blockIdx.y;
  const int cg = threadIdx.x % 48, rl = threadIdx.x / 48;
  const int t1 = min(Ta, (s + 1) * DMA_ROWS);
  const size_t base = (size_t)b * Ta * SF_D + cg * 8;
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  for (int t = s * DMA_ROWS + rl; t < t1; t += 8) {
    float kf[8], vf[8];
    bf16x8(load16(k + base + (size_t)t * SF_D), kf);
    bf16x8(load16(v + base + (size_t)t * SF_D), vf);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += kf[j] + vf[j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[rl][cg * 8 + j] = acc[j];
  __syncthreads();
  const int d = threadIdx.x;
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) sum += red[r][d];
  part[((size_t)b * S + s) * SF_D + d] = sum;
}

__global__ void __launch_bounds__(SF_D)
sf_dma_finish(const bf16* __restrict__ q, const float* __restrict__ part,
              float* __restrict__ out, int S) {
  const int b = blockIdx.x, d = threadIdx.x;
  float o = __bfloat162float(q[(size_t)b * SF_D + d]) * 1e-30f;
  for (int s = 0; s < S; ++s) o += part[((size_t)b * S + s) * SF_D + d];
  out[(size_t)b * SF_D + d] = o;
}

// ---------------------------------------------------------------------------
// Split merge (vpu, mxu_t, mxu_r): per (b, d) of head h, the splits'
// accumulators and sums rescaled to the largest max, then divided.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(SF_D)
sf_combine(const float* __restrict__ pacc, const float* __restrict__ pm,
           const float* __restrict__ ps, bf16* __restrict__ out, int S) {
  const int b = blockIdx.x, d = threadIdx.x, h = d / SF_DH;
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) M = fmaxf(M, pm[((size_t)b * S + s) * SF_H + h]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t i = (size_t)b * S + s;
    const float w = expf(pm[i * SF_H + h] - M);
    num += pacc[i * SF_D + d] * w;
    den += ps[i * SF_H + h] * w;
  }
  out[(size_t)b * SF_D + d] = __float2bfloat16(num / den);
}

// ---------------------------------------------------------------------------
// vpu: block (split, h, b); warp w holds head dims w * 8 .. w * 8 + 7 and
// lane l the positions c0 + 8 l .. c0 + 8 l + 7 of each chunk, so a warp
// reads 512 contiguous bytes of a (d, t) row.
// ---------------------------------------------------------------------------
constexpr int VPU_THREADS = 256, VPU_CHUNK = 256, VPU_SPLIT = 1024;

__global__ void __launch_bounds__(VPU_THREADS)
sf_vpu_partial(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, float* __restrict__ pacc,
               float* __restrict__ pm, float* __restrict__ ps, int Ta, int S) {
  __shared__ float lw[8][VPU_CHUNK];  // per-warp partial logits
  __shared__ float pr[VPU_CHUNK];     // this chunk's p
  __shared__ float red_m[8], red_s[8];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d0 = h * SF_DH + warp * 8;
  float qd[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) qd[j] = __bfloat162float(q[(size_t)b * SF_D + d0 + j]);
  const bf16* kb = k + ((size_t)b * SF_D + d0) * Ta;
  const bf16* vb = v + ((size_t)b * SF_D + d0) * Ta;
  const int t_end = min(Ta, (s + 1) * VPU_SPLIT);
  float m_run = -INFINITY, s_run = 0.f, acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;

  for (int c0 = s * VPU_SPLIT; c0 < t_end; c0 += VPU_CHUNK) {
    const int t = c0 + lane * 8;
    const bool valid = t < t_end;  // Ta % 8 == 0: all 8 positions or none
    float l[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) l[e] = 0.f;
    if (valid) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float kf[8];
        bf16x8(load16(kb + (size_t)j * Ta + t), kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) l[e] = fmaf(qd[j], kf[e], l[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) lw[warp][lane * 8 + e] = l[e];
    __syncthreads();
    float lt = -INFINITY;
    if (c0 + tid < t_end) {
      lt = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) lt += lw[w][tid];
    }
    const float wm = warp_max(lt);
    if (lane == 0) red_m[warp] = wm;
    __syncthreads();
    float mx = red_m[0];
#pragma unroll
    for (int w = 1; w < 8; ++w) mx = fmaxf(mx, red_m[w]);
    const float m_new = fmaxf(m_run, mx);
    const float corr = expf(m_run - m_new);
    const float p = c0 + tid < t_end ? expf(lt - m_new) : 0.f;
    pr[tid] = p;
    const float ws = warp_sum(p);
    if (lane == 0) red_s[warp] = ws;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) total += red_s[w];
    s_run = s_run * corr + total;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pv = 0.f;
      if (valid) {
        float vf[8];
        bf16x8(load16(vb + (size_t)j * Ta + t), vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) pv = fmaf(pr[lane * 8 + e], vf[e], pv);
      }
      acc[j] = acc[j] * corr + warp_sum(pv);
    }
  }
  const size_t i = (size_t)b * S + s;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) pacc[i * SF_D + d0 + j] = acc[j];
  }
  if (tid == 0) {
    pm[i * SF_H + h] = m_run;
    ps[i * SF_H + h] = s_run;
  }
}

// ---------------------------------------------------------------------------
// mxu_t: block (split, b), 4 warps.  Per chunk of 64 positions: K and V
// (384, 64) staged in shared memory; logits (16, 64) = qexp (16, 384) K,
// warp w the columns 16 w ..; p (16, 64) bf16; PV (384, 16) = V p^T, warp w
// the row tiles w, w + 4, ...; thread d keeps acc[d] += PV[d, head(d)].
// ---------------------------------------------------------------------------
namespace wm = nvcuda::wmma;

constexpr int MT_THREADS = 128, MT_CHUNK = 64, MT_SPLIT = 256;
constexpr int MT_LDQ = SF_D + 8, MT_LDK = MT_CHUNK + 8, MT_LDL = MT_CHUNK + 4;
constexpr int MT_LDP = MT_CHUNK + 8, MT_LDO = 16 + 4;
constexpr int MT_SMEM = 2 * 16 * MT_LDQ + 2 * 2 * SF_D * MT_LDK + 4 * 16 * MT_LDL +
                        2 * 16 * MT_LDP + 4 * SF_D * MT_LDO + 4 * 3 * 16;

// Stage rows [0, rows) x positions [c0, c0 + 8 * parts) of a T-on-lanes
// (rows, Ta) slab into shared memory (row stride ld), zeros past t_end.
__device__ __forceinline__ void stage_lanes(const bf16* src, int Ta, int rows, int parts,
                                            int c0, int t_end, bf16* dst, int ld, int tid,
                                            int nthreads) {
  for (int i = tid; i < rows * parts; i += nthreads) {
    const int r = i / parts, part = i % parts, t = c0 + part * 8;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (t < t_end) w = load16(src + (size_t)r * Ta + t);
    *reinterpret_cast<uint4*>(dst + r * ld + part * 8) = w;
  }
}

__global__ void __launch_bounds__(MT_THREADS)
sf_mxu_t_partial(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ pacc,
                 float* __restrict__ pm, float* __restrict__ ps, int Ta, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qx = reinterpret_cast<bf16*>(smem);  // [16][MT_LDQ]
  bf16* ks = qx + 16 * MT_LDQ;                // [384][MT_LDK]
  bf16* vs = ks + SF_D * MT_LDK;              // [384][MT_LDK]
  float* lg = reinterpret_cast<float*>(vs + SF_D * MT_LDK);  // [16][MT_LDL]
  bf16* pb = reinterpret_cast<bf16*>(lg + 16 * MT_LDL);      // [16][MT_LDP]
  float* pv = reinterpret_cast<float*>(pb + 16 * MT_LDP);    // [384][MT_LDO]
  float* st_m = pv + SF_D * MT_LDO;
  float* st_s = st_m + 16;
  float* st_c = st_s + 16;
  const int s = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t_end = min(Ta, (s + 1) * MT_SPLIT);
  const bf16 zero = __float2bfloat16(0.f);

  // Block-diagonal q: row h < 6 holds q's head-h slice in its own columns.
  for (int i = tid; i < 16 * SF_D; i += MT_THREADS) {
    const int r = i / SF_D, c = i % SF_D;
    qx[r * MT_LDQ + c] = (r < SF_H && c / SF_DH == r) ? q[(size_t)b * SF_D + c] : zero;
  }
  if (tid < 16) {
    st_m[tid] = -INFINITY;
    st_s[tid] = 0.f;
  }
  float acc[SF_D / MT_THREADS];
#pragma unroll
  for (int j = 0; j < SF_D / MT_THREADS; ++j) acc[j] = 0.f;
  const bf16* kb = k + (size_t)b * SF_D * Ta;
  const bf16* vb = v + (size_t)b * SF_D * Ta;

  for (int c0 = s * MT_SPLIT; c0 < t_end; c0 += MT_CHUNK) {
    __syncthreads();  // the previous chunk is done with ks, vs, pb and pv
    stage_lanes(kb, Ta, SF_D, MT_CHUNK / 8, c0, t_end, ks, MT_LDK, tid, MT_THREADS);
    stage_lanes(vb, Ta, SF_D, MT_CHUNK / 8, c0, t_end, vs, MT_LDK, tid, MT_THREADS);
    __syncthreads();
    {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fb;
      wm::fragment<wm::accumulator, 16, 16, 16, float> fc;
      wm::fill_fragment(fc, 0.f);
      for (int kk = 0; kk < SF_D / 16; ++kk) {
        wm::load_matrix_sync(fa, qx + kk * 16, MT_LDQ);
        wm::load_matrix_sync(fb, ks + kk * 16 * MT_LDK + warp * 16, MT_LDK);
        wm::mma_sync(fc, fa, fb, fc);
      }
      wm::store_matrix_sync(lg + warp * 16, fc, MT_LDL, wm::mem_row_major);
    }
    __syncthreads();
    // Online softmax of each head row; p rounded to bf16 for PV and the sum.
    for (int r = warp; r < 16; r += 4) {
      float p0 = 0.f, p1 = 0.f;
      if (r < SF_H) {
        const float x0 = c0 + lane < t_end ? lg[r * MT_LDL + lane] : -INFINITY;
        const float x1 = c0 + lane + 32 < t_end ? lg[r * MT_LDL + lane + 32] : -INFINITY;
        const float m_old = st_m[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
        p0 = rnd<bf16>(expf(x0 - m_new));
        p1 = rnd<bf16>(expf(x1 - m_new));
        const float sum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          st_s[r] = st_s[r] * corr + sum;
          st_m[r] = m_new;
          st_c[r] = corr;
        }
      }
      pb[r * MT_LDP + lane] = __float2bfloat16(p0);
      pb[r * MT_LDP + lane + 32] = __float2bfloat16(p1);
    }
    __syncthreads();
    {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major> fb;
      wm::fragment<wm::accumulator, 16, 16, 16, float> fc;
      for (int mt = warp; mt < SF_D / 16; mt += 4) {
        wm::fill_fragment(fc, 0.f);
#pragma unroll
        for (int kk = 0; kk < MT_CHUNK / 16; ++kk) {
          wm::load_matrix_sync(fa, vs + mt * 16 * MT_LDK + kk * 16, MT_LDK);
          wm::load_matrix_sync(fb, pb + kk * 16, MT_LDP);  // p^T: (t, head)
          wm::mma_sync(fc, fa, fb, fc);
        }
        wm::store_matrix_sync(pv + mt * 16 * MT_LDO, fc, MT_LDO, wm::mem_row_major);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SF_D / MT_THREADS; ++j) {
      const int d = tid + j * MT_THREADS, h = d / SF_DH;
      acc[j] = acc[j] * st_c[h] + pv[d * MT_LDO + h];
    }
  }
  const size_t i = (size_t)b * S + s;
#pragma unroll
  for (int j = 0; j < SF_D / MT_THREADS; ++j) pacc[i * SF_D + tid + j * MT_THREADS] = acc[j];
  if (tid < SF_H) {
    pm[i * SF_H + tid] = st_m[tid];
    ps[i * SF_H + tid] = st_s[tid];
  }
}

// ---------------------------------------------------------------------------
// mxu_r: block (split, group of 8 rows), 4 warps.  Per chunk of 16
// positions: the K tile (8 rows x 16 positions, 384) in shared memory;
// logits (128, 48) = K qcols, where column c = 6 i + h holds row i's head-h
// q slice, warp w the tiles w, w + 4, ... of 8 x 3; thread c < 48 keeps
// its column's online max and fp32 sum over its own row's 16 logits (the
// other 112 are the masked cross-row products) and writes p (bf16, 0 where
// masked); then V's tile replaces K's, PV (48, 384) = p^T V, and of each
// 16 x 16 output tile the head-diagonal entries (c, d), d / 64 == c % 6,
// update acc[c / 6][d].
// ---------------------------------------------------------------------------
constexpr int MR_THREADS = 128, MR_ROWS = 8, MR_COLS = MR_ROWS * SF_H, MR_CHUNK = 16;
constexpr int MR_SPLIT = 64, MR_M = MR_ROWS * MR_CHUNK;
constexpr int MR_LDKV = SF_D + 8, MR_LDQ = MR_COLS + 8, MR_LDL = MR_COLS + 4;
constexpr int MR_LDP = MR_COLS + 8;
constexpr int MR_SMEM = 2 * MR_M * MR_LDKV + 2 * SF_D * MR_LDQ + 4 * MR_M * MR_LDL +
                        2 * MR_M * MR_LDP + 4 * MR_ROWS * SF_D + 4 * 4 * 256 +
                        4 * 3 * MR_COLS;

// Stage the (8 rows x 16 positions, 384) tile of a row-major (B, Ta, D)
// array, zeros past t_end.
__device__ __forceinline__ void stage_rows(const bf16* src, int b0, int Ta, int c0,
                                           int t_end, bf16* dst, int tid) {
  constexpr int parts = SF_D / 8;
  for (int i = tid; i < MR_M * parts; i += MR_THREADS) {
    const int r = i / parts, part = i % parts;
    const int row = r / MR_CHUNK, t = c0 + r % MR_CHUNK;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (t < t_end) w = load16(src + ((size_t)(b0 + row) * Ta + t) * SF_D + part * 8);
    *reinterpret_cast<uint4*>(dst + r * MR_LDKV + part * 8) = w;
  }
}

__global__ void __launch_bounds__(MR_THREADS)
sf_mxu_r_partial(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, float* __restrict__ pacc,
                 float* __restrict__ pm, float* __restrict__ ps, int Ta, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* kv = reinterpret_cast<bf16*>(smem);  // [128][MR_LDKV]: K, then V
  bf16* qc = kv + MR_M * MR_LDKV;             // [384][MR_LDQ]
  float* lg = reinterpret_cast<float*>(qc + SF_D * MR_LDQ);  // [128][MR_LDL]
  bf16* pb = reinterpret_cast<bf16*>(lg + MR_M * MR_LDL);    // [128][MR_LDP]
  float* acc = reinterpret_cast<float*>(pb + MR_M * MR_LDP); // [8][384]
  float* ws = acc + MR_ROWS * SF_D;                          // [4 warps][16 x 16]
  float* st_m = ws + 4 * 256;
  float* st_s = st_m + MR_COLS;
  float* st_c = st_s + MR_COLS;
  const int s = blockIdx.x, b0 = blockIdx.y * MR_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t_end = min(Ta, (s + 1) * MR_SPLIT);
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < SF_D * MR_COLS; i += MR_THREADS) {
    const int d = i / MR_COLS, c = i % MR_COLS;
    qc[d * MR_LDQ + c] = d / SF_DH == c % SF_H ? q[(size_t)(b0 + c / SF_H) * SF_D + d] : zero;
  }
  for (int i = tid; i < MR_ROWS * SF_D; i += MR_THREADS) acc[i] = 0.f;
  if (tid < MR_COLS) {
    st_m[tid] = -INFINITY;
    st_s[tid] = 0.f;
  }

  for (int c0 = s * MR_SPLIT; c0 < t_end; c0 += MR_CHUNK) {
    __syncthreads();  // the previous chunk is done with kv, pb and acc
    stage_rows(k, b0, Ta, c0, t_end, kv, tid);
    __syncthreads();
    {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major> fa;
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fb;
      wm::fragment<wm::accumulator, 16, 16, 16, float> fc;
      for (int tile = warp; tile < (MR_M / 16) * (MR_COLS / 16); tile += 4) {
        const int mt = tile / (MR_COLS / 16), nt = tile % (MR_COLS / 16);
        wm::fill_fragment(fc, 0.f);
        for (int kk = 0; kk < SF_D / 16; ++kk) {
          wm::load_matrix_sync(fa, kv + mt * 16 * MR_LDKV + kk * 16, MR_LDKV);
          wm::load_matrix_sync(fb, qc + kk * 16 * MR_LDQ + nt * 16, MR_LDQ);
          wm::mma_sync(fc, fa, fb, fc);
        }
        wm::store_matrix_sync(lg + mt * 16 * MR_LDL + nt * 16, fc, MR_LDL, wm::mem_row_major);
      }
    }
    __syncthreads();  // K consumed: V's tile may replace it
    stage_rows(v, b0, Ta, c0, t_end, kv, tid);
    if (tid < MR_COLS) {
      const int c = tid, row = c / SF_H;
      float mx = -INFINITY;
      for (int j = 0; j < MR_CHUNK && c0 + j < t_end; ++j)
        mx = fmaxf(mx, lg[(row * MR_CHUNK + j) * MR_LDL + c]);
      const float m_old = st_m[c], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = 0; r < MR_M; ++r) {
        float p = 0.f;
        if (r / MR_CHUNK == row && c0 + r % MR_CHUNK < t_end)
          p = expf(lg[r * MR_LDL + c] - m_new);
        sum += p;
        pb[r * MR_LDP + c] = __float2bfloat16(p);
      }
      const float corr = expf(m_old - m_new);
      st_s[c] = st_s[c] * corr + sum;
      st_m[c] = m_new;
      st_c[c] = corr;
    }
    __syncthreads();
    {
      wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major> fa;  // p^T
      wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major> fb;
      wm::fragment<wm::accumulator, 16, 16, 16, float> fc;
      float* w_s = ws + warp * 256;
      for (int tile = warp; tile < (MR_COLS / 16) * (SF_D / 16); tile += 4) {
        const int mt = tile / (SF_D / 16), nt = tile % (SF_D / 16);
        wm::fill_fragment(fc, 0.f);
#pragma unroll
        for (int kk = 0; kk < MR_M / 16; ++kk) {
          wm::load_matrix_sync(fa, pb + kk * 16 * MR_LDP + mt * 16, MR_LDP);
          wm::load_matrix_sync(fb, kv + kk * 16 * MR_LDKV + nt * 16, MR_LDKV);
          wm::mma_sync(fc, fa, fb, fc);
        }
        wm::store_matrix_sync(w_s, fc, 16, wm::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int c = mt * 16 + e / 16, d = nt * 16 + e % 16;
          if (c % SF_H == d / SF_DH) {
            float* a = acc + (c / SF_H) * SF_D + d;
            *a = *a * st_c[c] + w_s[e];
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < MR_ROWS * SF_D; i += MR_THREADS) {
    const int row = i / SF_D, d = i % SF_D;
    pacc[((size_t)(b0 + row) * S + s) * SF_D + d] = acc[i];
  }
  if (tid < MR_COLS) {
    const size_t i = (size_t)(b0 + tid / SF_H) * S + s;
    pm[i * SF_H + tid % SF_H] = st_m[tid];
    ps[i * SF_H + tid % SF_H] = st_s[tid];
  }
}

inline int sf_splits(int mode, int Ta) {
  const int split = mode == kSfDma ? DMA_ROWS
                  : mode == kSfVpu ? VPU_SPLIT
                  : mode == kSfMxuT ? MT_SPLIT : MR_SPLIT;
  return (Ta + split - 1) / split;
}

}  // namespace qasr

using namespace qasr;

// q (B, 384) bf16; k, v bf16 (B, Ta, 384) for dma and mxu_r, (B, 384, Ta)
// for vpu and mxu_t, 16-byte aligned, Ta a multiple of 64 (mxu_r: B a
// multiple of 8); out (B, 384) fp32 for dma, bf16 otherwise; scratch
// B * splits * (384 + 12) fp32, with splits = ceil(Ta / the mode's split).
// mode 0 dma, 1 vpu, 2 mxu_t, 3 mxu_r.
extern "C" int qasr_step_formulations(int mode, const void* q, const void* k, const void* v,
                                      void* out, void* scratch, int B, int Ta, int splits,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
  if (mode < kSfDma || mode > kSfMxuR || Ta % 64 || splits != sf_splits(mode, Ta) ||
      (mode == kSfMxuR && B % MR_ROWS))
    return (int)cudaErrorInvalidValue;
  const int S = splits;
  float* pacc = (float*)scratch;
  float* pm = pacc + (size_t)B * S * SF_D;
  float* ps = pm + (size_t)B * S * SF_H;
  if (mode == kSfDma) {
    sf_dma_partial<<<dim3(S, B), DMA_THREADS, 0, st>>>(kk, vv, pacc, Ta, S);
    QASR_TRY(cudaGetLastError());
    sf_dma_finish<<<B, SF_D, 0, st>>>(qq, pacc, (float*)out, S);
    return (int)cudaGetLastError();
  }
  if (mode == kSfVpu) {
    sf_vpu_partial<<<dim3(S, SF_H, B), VPU_THREADS, 0, st>>>(qq, kk, vv, pacc, pm, ps, Ta, S);
  } else if (mode == kSfMxuT) {
    QASR_TRY(cudaFuncSetAttribute(sf_mxu_t_partial,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, MT_SMEM));
    sf_mxu_t_partial<<<dim3(S, B), MT_THREADS, MT_SMEM, st>>>(qq, kk, vv, pacc, pm, ps, Ta, S);
  } else {
    QASR_TRY(cudaFuncSetAttribute(sf_mxu_r_partial,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, MR_SMEM));
    sf_mxu_r_partial<<<dim3(S, B / MR_ROWS), MR_THREADS, MR_SMEM, st>>>(qq, kk, vv, pacc, pm,
                                                                        ps, Ta, S);
  }
  QASR_TRY(cudaGetLastError());
  sf_combine<<<B, SF_D, 0, st>>>(pacc, pm, ps, (bf16*)out, S);
  return (int)cudaGetLastError();
}
