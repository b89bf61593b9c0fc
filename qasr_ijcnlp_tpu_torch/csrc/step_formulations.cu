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
//          k, v (B, D, Ta) "T-on-lanes", on the CUDA cores
//   mxu_t  `_mxu_t_kernel` (:95): the same on the tensor cores, row by row,
//          q expanded block-diagonally; p rounded to bf16 for PV and for the
//          sum
//   mxu_r  `_mxu_r_kernel` (:138): row-major k, v (B, Ta, D) in groups of 8
//          rows against block-diagonal q columns (48 = 8 rows x 6 heads),
//          the cross-row products computed and masked, the online max and
//          fp32 sum per (row, head) column, p rounded to bf16 for PV; of the
//          (48, D) PV product only the head-diagonal entries are kept.  The
//          TPU body wrote its raw, unnormalised accumulator rows ("here just
//          dump raw acc"); this kernel writes the normalised attention.
//
// What bounds it: every mode reads 2 B Ta D bf16 bytes of K and V (151 MB at
// B = 64, Ta = 1536: 45 us at 3.35 TB/s) for 4 B Ta D operations (padded:
// ~8 FLOP a byte for mxu_t, ~48 for mxu_r, far under the tensor cores'
// ~295), so all four are bound by bytes.  The design keeps the copies
// running whatever the consumer does, so that "mode - dma" is each
// formulation's own cost:
//
// * One skeleton.  Block (split s, group g) owns the chunks [s n / S, (s + 1)
//   n / S) of its group's n = Ta / C chunks (group: one row; mxu_r: 8 rows).
//   Lane 0 of a producer warp keeps copies in flight into a ring of ST
//   slots of 48 KB on full/empty mbarriers, alternating K and V items of
//   each chunk: dma's row-major runs (C = 64 positions x 768 bytes) by one
//   1D bulk copy; vpu's and mxu_t's T-on-lanes slabs (384 x C = 64) by a 4D
//   TMA box (64 positions, 64 d, 6 heads, 1) that lands as [d][64 t], rows
//   of 128 bytes in the 128-byte swizzle, which wgmma reads both as K^T
//   (MN-major) and as V (K-major); mxu_r's (8 rows x C = 8 positions, 384)
//   tiles by a 4D box (64 d, 8 t, 6 heads, 8 rows) that lands as [row]
//   [head][t][64 d], 1024-byte swizzle atoms read as K (K-major) and V^T
//   (MN-major).  Every box row is 128 bytes: with 16-byte rows (the
//   no-swizzle core-matrix layout) TMA's request rate, not the bytes, bound
//   vpu, mxu_t and mxu_r at 91-140 us.  mxu_r's row-major runs go through
//   TMA, not 1D copies, because wgmma reads an operand only in those
//   layouts, which a copy of 768-byte rows cannot give.
// * Consumers, one named barrier among them:
//   dma    384 threads sum each item in fp32 (16-byte loads);
//   vpu    384 threads, fp32 FMAs: thread (t / 8, head, segment) takes 8 d of
//          8 positions (16-byte loads, the d order rotated by the segment so
//          that, with the swizzle, a quarter warp hits 8 banks), the
//          segments' logits summed by a
//          3-step shuffle reduce-scatter; warp h runs head h's online
//          softmax; PV likewise, each thread's 8 accumulators rescaled;
//   mxu_t  one warpgroup: logits^T (64 x 8) = K^T (positions as M, read
//          MN-major from the slab) . qexp^T (384 x 8, heads as N, staged
//          once), wgmma m64n8k16; p (bf16, 64 x 8) written to shared memory
//          (fence.proxy.async); O^T (384 x 8) += V (d as M, K-major in the
//          same slab) . p, six m64n8 accumulators rescaled per column; the
//          head-diagonal column kept;
//   mxu_r  one warpgroup: logits (64 (row, t) x 48) = K (K-major) . qcols
//          (384 x 48, staged once), wgmma m64n48k16, each (row, head)
//          column's 8 real logits in one warp (the rest masked); PV as O^T
//          (384 x 48) = V^T (MN-major) . p per head's 64 d into a fresh
//          accumulator whose 8 head-diagonal columns (one per row) are
//          rescaled and added on the CUDA cores.
// * Merge in the same launch: each block writes its (m, l, acc) to a
//   scratch slot; the last block of a group, by an atomic ticket per group
//   in global memory, merges the S slots (sum_s e^(m_s - M) acc_s / sum_s
//   e^(m_s - M) l_s; dma: the plain sum) and resets the ticket to 0 for the
//   next call.  Not a cluster as K9: B = 64 leaves mxu_r 8 groups, which
//   need 16 splits each to put a block on every SM, above the portable
//   cluster size of 8, and a 16-block cluster needs 16 free SMs of one
//   GPC at once.
// * Splits (``sf_splits``): one block per SM (the ring takes 144-192 KB),
//   S = min(n, SMs / groups): 2 at B = 64 (mxu_r 16), 128 blocks.
#include <algorithm>

#include "hopper.cuh"

namespace qasr {

using bf16 = __nv_bfloat16;

constexpr int SF_D = 384, SF_H = 6, SF_DH = 64;
enum SfMode : int { kSfDma = 0, kSfVpu = 1, kSfMxuT = 2, kSfMxuR = 3 };
constexpr int SF_SLOT = 49152;  // one ring slot: one K or V item

__host__ __device__ constexpr int sf_chunk(int m) { return m == kSfMxuR ? 8 : 64; }
__host__ __device__ constexpr int sf_stages(int m) { return m == kSfMxuR ? 3 : 4; }
__host__ __device__ constexpr int sf_consumers(int m) { return m <= kSfVpu ? 384 : 128; }
__host__ __device__ constexpr int sf_rows(int m) { return m == kSfMxuR ? 8 : 1; }
__host__ __device__ constexpr int sf_threads(int m) { return sf_consumers(m) + 32; }
// Bytes after the ring: vpu's logits, p (6 x 64 fp32 each) and rescales;
// mxu_t's qexp (384 x 8 bf16), p (64 x 8 bf16) and two cross-warp
// reductions; mxu_r's qcols (384 x 48 bf16), p (64 x 48 bf16) and two
// rounds of column rescales.
__host__ __device__ constexpr int sf_extra(int m) {
  return m == kSfVpu ? 2 * SF_H * 64 * 4 + 64
       : m == kSfMxuT ? SF_D * 8 * 2 + 64 * 8 * 2 + 2 * 4 * 8 * 4
       : m == kSfMxuR ? SF_D * 48 * 2 + 64 * 48 * 2 + 2 * 48 * 4 : 0;
}
__host__ __device__ constexpr int sf_bar_offset(int m) {
  return sf_stages(m) * SF_SLOT + sf_extra(m) + 16;
}
// 1024 bytes of slack to align the ring to the swizzle atom
__host__ __device__ constexpr int sf_smem(int m) {
  return 1024 + sf_bar_offset(m) + 2 * sf_stages(m) * 8;
}
// Floats of one block's scratch slot: acc (rows x 384), then m and l
// (rows x 6 each).
__host__ __device__ constexpr int sf_slot_floats(int m) { return sf_rows(m) * (SF_D + 2 * SF_H); }

// Eight bf16 values of one 16-byte word as floats.
__device__ __forceinline__ void bf16x8(const uint4 w, float f[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

template <int M>
__global__ void __launch_bounds__(sf_threads(M), 1)
sf_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
          const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          void* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets, int Ta,
          int S) {
  constexpr int C = sf_chunk(M), ST = sf_stages(M), NC = sf_consumers(M), NR = sf_rows(M);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* extra = smem + ST * SF_SLOT;
  int* flag = reinterpret_cast<int*>(smem + sf_bar_offset(M) - 16);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + sf_bar_offset(M));
  uint64_t* empty = full + ST;
  auto slot = [&](int j) { return smem + (j % ST) * SF_SLOT; };

  const int s = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n = Ta / C, c_begin = s * n / S, items = 2 * ((s + 1) * n / S - c_begin);
  float* my = part + ((size_t)g * S + s) * sf_slot_floats(M);  // this block's slot

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NC / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NC) {  // ---- producer warp: item j is K (even) or V (odd) of chunk j / 2 ----
    if (lane == 0) {
      for (int j = 0; j < items; ++j) {
        const int i = j % ST, c0 = (c_begin + j / 2) * C;
        const bool is_v = j & 1;
        if (j >= ST) mbar_wait(&empty[i], (j / ST - 1) & 1);
        fence_proxy_async();  // the consumers' generic reads of the slot precede the copy
        mbar_expect_tx(&full[i], SF_SLOT);
        if constexpr (M == kSfDma)
          bulk_load(slot(j), (is_v ? v : k) + ((size_t)g * Ta + c0) * SF_D, SF_SLOT, &full[i]);
        else if constexpr (M == kSfMxuR)
          tma_load4(slot(j), is_v ? &mv : &mk, &full[i], 0, c0, 0, g * NR);
        else
          tma_load4(slot(j), is_v ? &mv : &mk, &full[i], c0, 0, 0, g);
      }
    }
  } else if constexpr (M == kSfDma) {
    // ---- dma: thread (row lane rl, 16-byte column group cg) ----
    const int rl = tid / 48, cg = tid % 48;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int j = 0; j < items; ++j) {
      mbar_wait(&full[j % ST], (j / ST) & 1);
      const uint4* w = reinterpret_cast<const uint4*>(slot(j));
#pragma unroll
      for (int r = rl; r < C; r += 8) {
        float f[8];
        bf16x8(w[r * 48 + cg], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += f[e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % ST]);
    }
    named_bar(1, NC);  // the ring is spent: its first slot holds the row lanes' sums
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int e = 0; e < 8; ++e) red[rl * SF_D + cg * 8 + e] = acc[e];
    named_bar(1, NC);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) sum += red[r * SF_D + tid];
    my[tid] = sum;
  } else if constexpr (M == kSfVpu) {
    // ---- vpu: thread (position group tg, head h, segment sg) takes d = 64 h + 8 sg
    // + (e + sg) % 8, e = 0..7, of positions 8 tg .. 8 tg + 7 ----
    float* lg = reinterpret_cast<float*>(extra);  // [6][64] logits of the chunk
    float* pr = lg + SF_H * 64;                    // [6][64] p
    float* corr = pr + SF_H * 64;                  // [6] rescale of the chunk
    const int sg = tid & 7, grp = tid >> 3, tg = grp / SF_H, h = grp % SF_H;
    const int d0 = h * SF_DH + 8 * sg;
    float qr[8], acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qr[e] = __bfloat162float(q[(size_t)g * SF_D + d0 + ((e + sg) & 7)]);
      acc[e] = 0.f;
    }
    float m_run = -INFINITY, l_run = 0.f;  // warp h < 6: head h's
    for (int j = 0; j < items; j += 2) {
      mbar_wait(&full[j % ST], (j / ST) & 1);
      const uint4* kw = reinterpret_cast<const uint4*>(slot(j));
      float l8[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) l8[t] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float f[8];
        const int d = d0 + ((e + sg) & 7);
        bf16x8(kw[d * 8 + (tg ^ (d & 7))], f);
#pragma unroll
        for (int t = 0; t < 8; ++t) l8[t] = fmaf(qr[e], f[t], l8[t]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % ST]);
      // reduce-scatter over the 8 segments: segment sg ends with position 8 tg + sg
#pragma unroll
      for (int w = 4; w >= 1; w >>= 1) {
        const bool hi = sg & w;
#pragma unroll
        for (int t = 0; t < w; ++t) {
          const float send = hi ? l8[t] : l8[t + w];
          const float keep = hi ? l8[t + w] : l8[t];
          l8[t] = keep + __shfl_xor_sync(0xffffffffu, send, w);
        }
      }
      lg[h * 64 + tg * 8 + sg] = l8[0];
      named_bar(1, NC);
      if (warp < SF_H) {  // warp h: head h's online softmax over the chunk
        const float x0 = lg[warp * 64 + lane], x1 = lg[warp * 64 + lane + 32];
        const float m_new = fmaxf(m_run, warp_max(fmaxf(x0, x1)));
        const float cr = expf(m_run - m_new), p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
        l_run = l_run * cr + warp_sum(p0 + p1);
        m_run = m_new;
        pr[warp * 64 + lane] = p0;
        pr[warp * 64 + lane + 32] = p1;
        if (lane == 0) corr[warp] = cr;
      }
      named_bar(1, NC);
      mbar_wait(&full[(j + 1) % ST], ((j + 1) / ST) & 1);
      const uint4* vw = reinterpret_cast<const uint4*>(slot(j + 1));
      const float4 pa = *reinterpret_cast<const float4*>(pr + h * 64 + tg * 8);
      const float4 pb = *reinterpret_cast<const float4*>(pr + h * 64 + tg * 8 + 4);
      const float p8[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float cr = corr[h];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float f[8];
        const int d = d0 + ((e + sg) & 7);
        bf16x8(vw[d * 8 + (tg ^ (d & 7))], f);
        float pv = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t) pv = fmaf(p8[t], f[t], pv);
        acc[e] = fmaf(acc[e], cr, pv);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(j + 1) % ST]);
    }
    named_bar(1, NC);  // the ring is spent: it holds the 8 position groups' sums
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int e = 0; e < 8; ++e) red[tg * SF_D + d0 + ((e + sg) & 7)] = acc[e];
    named_bar(1, NC);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) sum += red[r * SF_D + tid];
    my[tid] = sum;
    if (warp < SF_H && lane == 0) {
      my[SF_D + warp] = m_run;
      my[SF_D + SF_H + warp] = l_run;
    }
  } else if constexpr (M == kSfMxuT) {
    // ---- mxu_t: one warpgroup; accumulator rows 16 warp + gr (+ 8), columns 2 qd (+ 1) ----
    bf16* qx = reinterpret_cast<bf16*>(extra);      // [48][8][8]: qexp^T, K-major
    bf16* pb = qx + SF_D * 8;                       // [8][8][8]: p, K-major
    float* red = reinterpret_cast<float*>(pb + 64 * 8);  // [2][4 warps][8 columns]
    const int gr = lane >> 2, qd = lane & 3;
    for (int i = tid; i < SF_D * 8; i += NC) {
      const int d = (i / 64) * 8 + i % 8, col = (i / 8) % 8;
      qx[i] = d / SF_DH == col ? q[(size_t)g * SF_D + d] : __float2bfloat16(0.f);
    }
    fence_proxy_async();
    named_bar(1, NC);
    float o[SF_H][4];  // head h's O^T tile (64 d x 8 columns)
#pragma unroll
    for (int h = 0; h < SF_H; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[h][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    const bool real[2] = {2 * qd < SF_H, 2 * qd + 1 < SF_H};  // columns 6, 7 pad the heads
    for (int j = 0; j < items; j += 2) {
      mbar_wait(&full[j % ST], (j / ST) & 1);
      const bf16* ks = reinterpret_cast<const bf16*>(slot(j));
      float sacc[4] = {0.f, 0.f, 0.f, 0.f};
      wgmma_fence();
#pragma unroll
      // K^T MN-major: 8 d rows an atom, 1024 bytes apart (one M group, so the
      // M-group stride is given the same value)
      for (int kk = 0; kk < SF_D / 16; ++kk)
        Wgmma<8>::ss_mn(sacc, gmma_desc_sw128(ks + kk * 16 * 64, 1024, 1024),
                        gmma_desc(qx + kk * 128, 128, 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<4>(sacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % ST]);
      // column (head) max over the chunk's 64 positions: rows, lanes, warps
      float cr[2], p[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mt = fmaxf(sacc[e], sacc[2 + e]);
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
        if (gr == 0) red[warp * 8 + 2 * qd + e] = mt;
      }
      named_bar(1, NC);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = red[2 * qd + e];
#pragma unroll
        for (int w = 1; w < 4; ++w) mx = fmaxf(mx, red[w * 8 + 2 * qd + e]);
        const float m_new = fmaxf(m_run[e], mx);
        cr[e] = real[e] ? expf(m_run[e] - m_new) : 1.f;
        float ls = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          p[r][e] = real[e] ? rnd<bf16>(expf(sacc[2 * r + e] - m_new)) : 0.f;
          ls += p[r][e];  // mxu_t sums the rounded p
        }
        ls += __shfl_xor_sync(0xffffffffu, ls, 4);
        ls += __shfl_xor_sync(0xffffffffu, ls, 8);
        ls += __shfl_xor_sync(0xffffffffu, ls, 16);
        if (gr == 0) red[32 + warp * 8 + 2 * qd + e] = ls;
        m_run[e] = m_new;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)  // p at (position 16 warp + gr + 8 r, column 2 qd + e)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          pb[(2 * warp + r) * 64 + (2 * qd + e) * 8 + gr] = __float2bfloat16(p[r][e]);
      fence_proxy_async();
      named_bar(1, NC);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float ls = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) ls += red[32 + w * 8 + 2 * qd + e];
        l_run[e] = l_run[e] * cr[e] + ls;
      }
#pragma unroll
      for (int h = 0; h < SF_H; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[h][e] *= cr[e & 1];
      mbar_wait(&full[(j + 1) % ST], ((j + 1) / ST) & 1);
      const bf16* vs = reinterpret_cast<const bf16*>(slot(j + 1));
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < SF_H; ++h)
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)  // V K-major: 16 positions a step, SBO 8 d rows
          Wgmma<8>::ss(o[h], gmma_desc_sw128(vs + h * SF_DH * 64 + kk * 16, 16, 1024),
                       gmma_desc(pb + kk * 128, 128, 128), bf16());
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int h = 0; h < SF_H; ++h) fence_regs<4>(o[h]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(j + 1) % ST]);
    }
    // head h's output is column h of its tile: lanes with qd = h / 2
#pragma unroll
    for (int h = 0; h < SF_H; ++h)
      if (qd == h / 2)
#pragma unroll
        for (int r = 0; r < 2; ++r) my[h * SF_DH + 16 * warp + gr + 8 * r] = o[h][2 * r + h % 2];
    if (warp == 0 && gr == 0)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (real[e]) {
          my[SF_D + 2 * qd + e] = m_run[e];
          my[SF_D + SF_H + 2 * qd + e] = l_run[e];
        }
  } else {
    // ---- mxu_r: one warpgroup; logits rows 16 warp + gr (+ 8) = (row 2 warp (+ 1),
    // position gr), columns 8 j + 2 qd (+ 1), j = 0..5 ----
    bf16* qc = reinterpret_cast<bf16*>(extra);  // [48][48][8]: qcols, K-major
    bf16* pb = qc + SF_D * 48;                  // [8 rows][48][8 positions]: p, K-major
    float* corr = reinterpret_cast<float*>(pb + 64 * 48);  // [2][48] column rescales
    const int gr = lane >> 2, qd = lane & 3;
    for (int i = tid; i < SF_D * 48; i += NC) {
      const int d = (i / 384) * 8 + i % 8, col = (i / 8) % 48;
      qc[i] = d / SF_DH == col % SF_H ? q[(size_t)(g * NR + col / SF_H) * SF_D + d]
                                      : __float2bfloat16(0.f);
    }
    for (int i = tid; i < 64 * 48; i += NC) pb[i] = __float2bfloat16(0.f);
    fence_proxy_async();
    named_bar(1, NC);
    // The thread's real logits: for each half r and column parity e, the one
    // column c = 8 jc + 2 qd + e of row 2 warp + r, if any (c / 6 == that row).
    int col[2][2], jc[2][2];
    float m_run[2][2], l_run[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int base = SF_H * (2 * warp + r), off = (2 * qd + e - base) & 7;
        col[r][e] = off < SF_H ? base + off : -1;
        jc[r][e] = (base + off) / 8;
        m_run[r][e] = -INFINITY;
        l_run[r][e] = 0.f;
      }
    float acc[SF_H][2][2];  // (head h, jj, r): row (8 (j0 + 3 jj) + 2 qd + h % 2) / 6,
#pragma unroll            // d = 64 h + 16 warp + gr + 8 r, j0 = ((h - h % 2) / 2 - qd) mod 3
    for (int h = 0; h < SF_H; ++h)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[h][x / 2][x % 2] = 0.f;
    for (int j = 0; j < items; j += 2) {
      const int round = (j / 2) & 1;
      mbar_wait(&full[j % ST], (j / ST) & 1);
      const bf16* ks = reinterpret_cast<const bf16*>(slot(j));
      float sacc[24];
#pragma unroll
      for (int i = 0; i < 24; ++i) sacc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SF_D / 16; ++kk)  // K K-major: head kk / 4's atoms, SBO a row
        Wgmma<48>::ss(sacc, gmma_desc_sw128(ks + (kk / 4) * 512 + (kk % 4) * 16, 16, 6144),
                      gmma_desc(qc + kk * 2 * 384, 48 * 16, 128), bf16());
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<24>(sacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % ST]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool real = col[r][e] >= 0;
          float x = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < 6; ++jj)
            if (real && jc[r][e] == jj) x = sacc[4 * jj + 2 * r + e];
          float mt = x;  // the column's 8 positions are the lanes of this qd
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
          const float m_new = fmaxf(m_run[r][e], mt);
          const float cr = real ? expf(m_run[r][e] - m_new) : 1.f;
          const float p = real ? expf(x - m_new) : 0.f;
          float ls = p;  // mxu_r sums the fp32 p
          ls += __shfl_xor_sync(0xffffffffu, ls, 4);
          ls += __shfl_xor_sync(0xffffffffu, ls, 8);
          ls += __shfl_xor_sync(0xffffffffu, ls, 16);
          if (real) {
            l_run[r][e] = l_run[r][e] * cr + ls;
            m_run[r][e] = m_new;
            pb[(2 * warp + r) * 384 + col[r][e] * 8 + gr] = __float2bfloat16(p);
            if (gr == 0) corr[round * 48 + col[r][e]] = cr;
          }
        }
      fence_proxy_async();
      named_bar(1, NC);
      mbar_wait(&full[(j + 1) % ST], ((j + 1) / ST) & 1);
      const bf16* vs = reinterpret_cast<const bf16*>(slot(j + 1));
      const float* cw = corr + round * 48;
#pragma unroll
      for (int h = 0; h < SF_H; ++h) {
        float tmp[24];
#pragma unroll
        for (int i = 0; i < 24; ++i) tmp[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // V^T MN-major: head h's atoms, a row's 6144 apart
          Wgmma<48>::ss_mn(tmp, gmma_desc_sw128(vs + h * 512 + kk * 2 * 3072, 6144, 6144),
                           gmma_desc(pb + kk * 2 * 384, 48 * 16, 128));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<24>(tmp);
        const int e = h % 2;
        const int j0 = (((h - e) / 2 - qd) % 3 + 3) % 3;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = 0.f;
#pragma unroll
            for (int a = 0; a < 3; ++a)
              if (a == j0) x = tmp[4 * (a + 3 * jj) + 2 * r + e];
            const int c = 8 * (j0 + 3 * jj) + 2 * qd + e;
            acc[h][jj][r] = fmaf(acc[h][jj][r], cw[c], x);
          }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(j + 1) % ST]);
    }
#pragma unroll
    for (int h = 0; h < SF_H; ++h) {
      const int e = h % 2, j0 = (((h - e) / 2 - qd) % 3 + 3) % 3;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = (8 * (j0 + 3 * jj) + 2 * qd + e) / SF_H;
          my[row * SF_D + h * SF_DH + 16 * warp + gr + 8 * r] = acc[h][jj][r];
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (col[r][e] >= 0 && gr == 0) {
          const int c = col[r][e];
          my[NR * SF_D + c] = m_run[r][e];  // c = 6 row + head
          my[NR * SF_D + NR * SF_H + c] = l_run[r][e];
        }
  }

  // ---- merge: the last block of the group to finish reads the S slots ----
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&tickets[g], 1) == S - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // The group's outputs as float4s, PER a thread, each summed over the S
  // slots with several loads in flight; the (m, l) of every slot and column
  // first staged in the (spent) ring and turned into weights.  A merge that
  // summed one output at a time, a dependent L2 load per slot, held mxu_r
  // (16 slots of 12 KB a group) at 104 us against 73 us.
  constexpr int NT = sf_threads(M), NV = NR * SF_D / 4, PER = (NV + NT - 1) / NT;
  constexpr int SF = sf_slot_floats(M), NHC = NR * SF_H;
  const float* slots = part + (size_t)g * S * SF;
  float4 num[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) num[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* w = reinterpret_cast<float*>(smem);  // [S][NHC] m, then e^(m - M)
  float* ls = w + S * NHC;                     // [S][NHC] l
  float* den = ls + S * NHC;                   // [NHC]
  if constexpr (M != kSfDma) {
    for (int i = tid; i < S * NHC; i += NT) {
      const float* sl = slots + (size_t)(i / NHC) * SF + NR * SF_D + i % NHC;
      w[i] = __ldcg(sl);
      ls[i] = __ldcg(sl + NHC);
    }
    __syncthreads();
    for (int c = tid; c < NHC; c += NT) {
      float mx = -INFINITY, d = 0.f;
      for (int i = 0; i < S; ++i) mx = fmaxf(mx, w[i * NHC + c]);
      for (int i = 0; i < S; ++i) {
        const float e = expf(w[i * NHC + c] - mx);
        w[i * NHC + c] = e;
        d = fmaf(e, ls[i * NHC + c], d);
      }
      den[c] = d;
    }
    __syncthreads();
  }
#pragma unroll 4
  for (int i = 0; i < S; ++i) {
    const float4* a = reinterpret_cast<const float4*>(slots + (size_t)i * SF);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int x = tid + u * NT;
      if (x < NV) {
        const float4 y = __ldcg(a + x);
        const float e = M == kSfDma ? 1.f : w[i * NHC + (4 * x / SF_D) * SF_H + (4 * x % SF_D) / SF_DH];
        num[u].x = fmaf(e, y.x, num[u].x);
        num[u].y = fmaf(e, y.y, num[u].y);
        num[u].z = fmaf(e, y.z, num[u].z);
        num[u].w = fmaf(e, y.w, num[u].w);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int x = tid + u * NT;
    if (x >= NV) continue;
    const size_t o = (size_t)g * NR * SF_D + 4 * x;  // (row, d) of the group's rows
    if constexpr (M == kSfDma) {
      float4 r = num[u];
      r.x += __bfloat162float(q[o]) * 1e-30f;
      r.y += __bfloat162float(q[o + 1]) * 1e-30f;
      r.z += __bfloat162float(q[o + 2]) * 1e-30f;
      r.w += __bfloat162float(q[o + 3]) * 1e-30f;
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = r;
    } else {
      const float d = den[(4 * x / SF_D) * SF_H + (4 * x % SF_D) / SF_DH];
      __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o);
      ob[0] = __floats2bfloat162_rn(num[u].x / d, num[u].y / d);
      ob[1] = __floats2bfloat162_rn(num[u].z / d, num[u].w / d);
    }
  }
  if (tid == 0) tickets[g] = 0;  // ready for the next call
}

// The splits of ``sf_kernel``: one block per SM for the groups (rows; mxu_r:
// groups of 8 rows), at most one per chunk.
inline int sf_splits(int mode, int B, int Ta, int sms) {
  const int groups = mode == kSfMxuR ? B / 8 : B, n = Ta / sf_chunk(mode);
  return std::max(1, std::min(n, sms / std::max(groups, 1)));
}

// The 4D map of a T-on-lanes (B, 384, Ta) array, box (64 positions, 64 d,
// 6 heads, 1) landing as [d][64 t], or of a row-major (B, Ta, 384) one, box
// (64 d, 8 positions, 6 heads, 8 rows) landing as [row][head][t][64 d]:
// 128-byte box rows in the 128-byte swizzle.
inline cudaError_t sf_encode(CUtensorMap* map, const void* base, bool lanes, int B, int Ta) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t T = (cuuint64_t)Ta;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const cuuint64_t dims[4] = {lanes ? T : 64, lanes ? 64 : T, SF_H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {lanes ? T * 2 : SF_D * 2, lanes ? 64 * T * 2 : 128,
                                 SF_D * T * 2};
  const cuuint32_t box[4] = {64, lanes ? 64u : 8u, SF_H, lanes ? 1u : 8u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int M>
int sf_launch(const bf16* q, const bf16* k, const bf16* v, void* out, float* part,
              int* tickets, int B, int Ta, int S, cudaStream_t st) {
  CUtensorMap mk{}, mv{};
  if constexpr (M != kSfDma) {
    QASR_TRY(sf_encode(&mk, k, M != kSfMxuR, B, Ta));
    QASR_TRY(sf_encode(&mv, v, M != kSfMxuR, B, Ta));
  }
  QASR_TRY(cudaFuncSetAttribute(sf_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                sf_smem(M)));
  const dim3 grid(S, M == kSfMxuR ? B / 8 : B);
  sf_kernel<M><<<grid, sf_threads(M), sf_smem(M), st>>>(mk, mv, q, k, v, out, part, tickets,
                                                         Ta, S);
  return (int)cudaGetLastError();
}

}  // namespace qasr

using namespace qasr;

// q (B, 384) bf16; k, v bf16 (B, Ta, 384) for dma and mxu_r, (B, 384, Ta)
// for vpu and mxu_t, 16-byte aligned, Ta a positive multiple of 64 (mxu_r:
// B a multiple of 8); out (B, 384) fp32 for dma, bf16 otherwise; scratch
// B * splits * 396 fp32; tickets one int32 per group (B, mxu_r B / 8), 0 at
// the call and left 0 by it; splits must be ``sf_splits`` of the current
// device.  mode 0 dma, 1 vpu, 2 mxu_t, 3 mxu_r.
extern "C" int qasr_step_formulations(int mode, const void* q, const void* k, const void* v,
                                      void* out, void* scratch, void* tickets, int B, int Ta,
                                      int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 0;
  QASR_TRY(cudaGetDevice(&dev));
  QASR_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (mode < kSfDma || mode > kSfMxuR || B < 1 || Ta < 64 || Ta % 64 ||
      (mode == kSfMxuR && B % 8) || splits != sf_splits(mode, B, Ta, sms) ||
      reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  const bf16 *qq = (const bf16*)q, *kk = (const bf16*)k, *vv = (const bf16*)v;
  float* part = (float*)scratch;
  int* tk = (int*)tickets;
  if (mode == kSfDma) return sf_launch<kSfDma>(qq, kk, vv, out, part, tk, B, Ta, splits, st);
  if (mode == kSfVpu) return sf_launch<kSfVpu>(qq, kk, vv, out, part, tk, B, Ta, splits, st);
  if (mode == kSfMxuT) return sf_launch<kSfMxuT>(qq, kk, vv, out, part, tk, B, Ta, splits, st);
  return sf_launch<kSfMxuR>(qq, kk, vv, out, part, tk, B, Ta, splits, st);
}
