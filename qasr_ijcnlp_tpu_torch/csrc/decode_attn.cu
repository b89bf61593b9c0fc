// int8 cross-attention of the decode loop (K9).
//
// Replaces qasr_ijcnlp_tpu/ops/decode_attn.py `_kernel`.  The cross K/V of a
// decoder layer are int8 codes (B, H, Tp, Dh) with one fp32 scale per
// (b, h, position); for the query rows of one (batch item, head):
//
//   logit_t = (q . code_k[t]) * scale_k[t]     (fp32; t >= t_real masked)
//   out = sum_t softmax(logit)_t * scale_v[t] * code_v[t]
//
// with q read in the compute dtype and scaled by Dh^-0.5 in fp32; the output
// is fp32.  Every (b, h) serves all its G * T_new query rows (a beam or
// best-of group shares one cached audio), RB rows per pass, so each code is
// read from device memory once per call whatever the group size.
//
// What bounds it on the H100: the bytes of the codes and scales (32.6 MB of
// the 1,500 real positions per layer and step at large-v3, B = 8: 9.8 us at
// 3.35 TB/s); the arithmetic is a few FMAs per byte at one query row, five
// times that at G = 5.  The TPU kernel's grid, one (b, h) per step with its
// whole (Dh, Tp) cache in VMEM, carried over as one block per (b, h), gave
// 160 blocks on 132 SMs at large-v3, each reading phase after phase with
// few bytes in flight: 8-15% of the HBM rate.  So here:
//
// * The audio axis is split over a cluster of S <= 8 blocks (grid (B H, S),
//   cluster (1, S, 1)): block s takes positions [s cs, min(t_real, (s + 1)
//   cs)), cs a multiple of 16.  The wrapper (ops/decode_attn.py `split`)
//   takes the largest S of 8, 7, 6 whose B H clusters the card holds at
//   once (cudaOccupancyMaxActiveClusters, ``qasr_int8_cross_attention_
//   clusters``): a second round of blocks would wait for the first to
//   finish, its copies overlapping no compute.  A block whose chunk holds
//   no real position gives m = -inf, l = 0, acc = 0.
// * Its chunk reaches shared memory by 1D bulk copies, each rounded up to
//   16 positions (inside Tp, a multiple of 128; the positions >= t_real
//   this brings in are never used): at the start K's codes and both
//   chunks' scales on one mbarrier; once the logits are done, V's codes,
//   on a second mbarrier, into the buffer K's codes held, so they land
//   while the softmax runs and PV waits only for them.  One buffer for
//   both halves the block's shared memory: at large-v3 a call's K and V
//   (33.4 MB) exceed the card's shared memory (132 x 227 KB), so with a
//   buffer each the blocks ran in two rounds.
// * In the block: logits four rows at a time (``logit_rows``: q's 16-value
//   slices in registers, a position's 16-byte code slices spread over the
//   lanes and summed by shuffles), then over all its positions and threads
//   the local max m_s, p = exp(logit - m_s), l_s = sum p and the weights p
//   scale_v, then acc_s[d] = sum p scale_v code_v[d] (16 threads per 64
//   columns, 8 position slices, each position's RB weights read as
//   vectors).  Codes become floats by a byte permute and one add.
// * The blocks merge in distributed shared memory: after cluster.sync(),
//   each output of a block's 1/S share of the rows x Dh reads every peer's
//   m, l and acc at once (map_shared_rank) and writes sum_s e^(m_s - M)
//   acc_s / sum_s e^(m_s - M) l_s, M = max m_s; a second cluster.sync()
//   keeps every block's shared memory alive until its peers have read it.
//   One launch per call, no global scratch.
//
// Any head width Dh <= 256 runs: where Dh is not a multiple of 16 the rows
// are not 16-byte aligned in shared memory and the kernel reads single
// bytes (kVec = false); the chunks' copies stay 16-byte multiples because
// every chunk starts and ends on a multiple of 16 positions.
#include <algorithm>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace qasr {

constexpr int I8_THREADS = 128;
constexpr int I8_WARPS = I8_THREADS / 32;
constexpr int I8_MAX_SPLIT = 8;                // the portable cluster size
constexpr int I8_CHUNK = 64;                   // PV columns per pass: 16 threads x 4 codes
constexpr int I8_SLICES = I8_THREADS / 16;     // PV position slices
constexpr int I8_LANES = 4;                    // logits: threads per position

// The four signed bytes of a 32-bit word as floats, exactly: each byte,
// biased by 128, becomes the low mantissa byte of 2^23 (one byte permute),
// and one add removes 2^23 + 128 (no integer-to-float conversion, which
// runs at half the FMA rate).
__device__ __forceinline__ void codes4(int w, float* c) {
  const uint32_t u = (uint32_t)w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    c[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + k)) - 8388736.0f;
}

__host__ __device__ constexpr int i8_align(int x, int m) { return (x + m - 1) / m * m; }

// The RB values of position i in a position-major [cs][RB] array.
template <int RB>
__device__ __forceinline__ void load_rows(const float* p, float* v) {
  if constexpr (RB % 4 == 0) {
#pragma unroll
    for (int r = 0; r < RB; r += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + r);
      v[r] = x.x, v[r + 1] = x.y, v[r + 2] = x.z, v[r + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) v[r] = p[r];
  }
}

template <int RB>
__device__ __forceinline__ void store_rows(float* p, const float* v) {
  if constexpr (RB % 4 == 0) {
#pragma unroll
    for (int r = 0; r < RB; r += 4)
      *reinterpret_cast<float4*>(p + r) = make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) p[r] = v[r];
  }
}

// Byte offsets of the dynamic shared memory of one block: its chunk's codes
// and scales (the bulk copies' destinations, 16-byte aligned), this pass's
// q rows, the logits / weights (position-major, so PV reads a position's RB
// weights as whole vectors), the softmax's per-warp partials, the PV
// partial sums of warps 1-3 (warp 0 adds them to its own), the (m, l, acc)
// its peers read, and the two mbarriers.  Shared memory bounds how many
// blocks an SM holds (7 at RB = 1, 6 at 4, 5 at 8 at large-v3's chunk).
struct I8Layout {
  int kc, vc, ks, vs, q, w, red, part, acc, ml, bar, bytes;
  __host__ __device__ I8Layout(int cs, int Dh, int RB) {
    kc = 0;
    vc = kc;  // V lands where K was, once the logits are done
    ks = vc + i8_align(cs * Dh, 16);
    vs = ks + 4 * cs;
    q = vs + 4 * cs;
    w = q + 4 * RB * Dh;
    red = w + 4 * RB * cs;
    part = red + 4 * 2 * I8_WARPS * RB;
    acc = part + 4 * (I8_WARPS - 1) * RB * I8_CHUNK;
    ml = acc + 4 * RB * Dh;
    bar = i8_align(ml + 4 * 2 * RB, 8);
    bytes = bar + 16;
  }
};

// Logits of GR query rows g0 .. g0 + GR - 1 (Dh a multiple of 16): LP lanes
// per position (the power of two >= Dh / 16), lane sub on the 16-byte slice
// sub of each of its positions' code rows, with q's slice of the GR rows
// held in registers (shared memory serves one 16-byte code load per 16 GR
// FMAs, not a q load per row); two partial sums per row halve the FMA
// chain; the LP lanes' sums are added by shuffles.  Written, times K's
// scale, into the position-major weights.
template <int GR, int RB>
__device__ __forceinline__ void logit_rows(const float* qs, const int8_t* kc, const float* ks,
                                           float* wts, int n, int Dh, int g0, int lane,
                                           int warp) {
  const int nsl = Dh / 16;
  const int LP = nsl <= 1 ? 1 : nsl <= 2 ? 2 : nsl <= 4 ? 4 : nsl <= 8 ? 8 : 16;
  const int sub = lane % LP, ppw = 32 / LP;
  float qr[GR][16];
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 x = sub < nsl
                           ? reinterpret_cast<const float4*>(qs + (g0 + r) * Dh + 16 * sub)[e]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[r][4 * e] = x.x, qr[r][4 * e + 1] = x.y, qr[r][4 * e + 2] = x.z,
      qr[r][4 * e + 3] = x.w;
    }
  for (int base = warp * ppw; base < n; base += I8_WARPS * ppw) {
    const int i = base + lane / LP;
    float acc[GR], acc2[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) acc[r] = acc2[r] = 0.f;
    if (i < n && sub < nsl) {
      const int4 w4 = *reinterpret_cast<const int4*>(kc + i * Dh + 16 * sub);
      float c[16];
      codes4(w4.x, c);
      codes4(w4.y, c + 4);
      codes4(w4.z, c + 8);
      codes4(w4.w, c + 12);
#pragma unroll
      for (int r = 0; r < GR; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc[r] = fmaf(qr[r][e], c[e], acc[r]);
          acc2[r] = fmaf(qr[r][8 + e], c[8 + e], acc2[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < GR; ++r) acc[r] += acc2[r];
    for (int o = 1; o < LP; o <<= 1)
#pragma unroll
      for (int r = 0; r < GR; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    if (i < n && sub == 0) {
      const float sc = ks[i];
#pragma unroll
      for (int r = 0; r < GR; ++r) acc[r] *= sc;
      store_rows<GR>(wts + i * RB + g0, acc);
    }
  }
}

// Blocks an SM must hold, which caps the registers: 10 at RB = 1 (48
// registers, so that large-v3's clusters all fit at once), 4 at RB = 4
// (128), 6 at RB = 8 (80).
constexpr int i8_min_blocks(int RB) { return RB == 1 ? 10 : RB == 4 ? 4 : 6; }

template <typename T, int RB, bool kVec>
__global__ void __launch_bounds__(I8_THREADS, i8_min_blocks(RB))
int8_xattn_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                  const float* __restrict__ sk, const int8_t* __restrict__ v8,
                  const float* __restrict__ sv, float* __restrict__ out, int G, int T_new,
                  int H, int Tp, int Dh, int t_real, int cs, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), s = (int)cluster.block_rank();
  const I8Layout L(cs, Dh, RB);
  int8_t* kc = reinterpret_cast<int8_t*>(smem + L.kc);
  int8_t* vc = reinterpret_cast<int8_t*>(smem + L.vc);
  float* ks = reinterpret_cast<float*>(smem + L.ks);
  float* vs = reinterpret_cast<float*>(smem + L.vs);
  float* qs = reinterpret_cast<float*>(smem + L.q);      // [RB][Dh] scaled q rows
  float* wts = reinterpret_cast<float*>(smem + L.w);     // [cs][RB] logits, then p scale_v
  float* red = reinterpret_cast<float*>(smem + L.red);   // [2][warps][RB] max, sum
  float* part = reinterpret_cast<float*>(smem + L.part); // [warps - 1][RB][I8_CHUNK]
  float* acc_s = reinterpret_cast<float*>(smem + L.acc); // [RB][Dh] sum p scale_v code_v
  float* m_s = reinterpret_cast<float*>(smem + L.ml);    // [RB] local max
  float* l_s = m_s + RB;                                 // [RB] local sum of p
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int D = H * Dh, R = G * T_new;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = min(s * cs, t_real);
  const int n = min(t_real, t0 + cs) - t0;  // this block's real positions, maybe 0
  const int n16 = i8_align(n, 16);          // copied: inside Tp, a multiple of 128

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  const size_t row0 = (size_t)bh * Tp + t0;
  const int code_bytes = n16 * Dh, scale_bytes = 4 * n16;
  // bars[0]: K's codes (and, at the first pass, both chunks' scales);
  // bars[1]: V's codes.  One phase of each per pass of RB rows.
  auto copy = [&](uint64_t* bar, int8_t* dst, const int8_t* src, bool scales) {
    if (n16 == 0) {
      mbar_arrive(bar);
      return;
    }
    fence_proxy_async();  // the generic reads of the buffer precede the copy
    mbar_expect_tx(bar, code_bytes + (scales ? 2 * scale_bytes : 0));
    bulk_load(dst, src + row0 * Dh, code_bytes, bar);
    if (scales) {
      bulk_load(ks, sk + row0, scale_bytes, bar);
      bulk_load(vs, sv + row0, scale_bytes, bar);
    }
  };
  if (tid == 0) copy(&bars[0], kc, k8, true);

  for (int r0 = 0; r0 < R; r0 += RB) {
    const int rows = min(RB, R - r0), phase = (r0 / RB) & 1;
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {  // independent loads, one per row
      const int r = r0 + rr, g = r / T_new, t = r % T_new;
      const T* qr = q + ((size_t)(b * G + g) * T_new + t) * D + h * Dh;
      for (int d = tid; d < Dh; d += I8_THREADS)
        qs[rr * Dh + d] = rr < rows ? to_f(qr[d]) * scale : 0.f;
    }
    __syncthreads();
    mbar_wait(&bars[0], phase);

    // Logits: where Dh is a multiple of 16 in groups of 4, 2 and 1 rows
    // (``logit_rows``); otherwise 4 lanes per position on single bytes d =
    // sub, sub + 4, ..., summed by shuffles.  Every lane takes part in every
    // shuffle; positions >= n compute zeros and store nothing.
    if (kVec) {
      int g0 = 0;
      if constexpr (RB >= 4)
        for (; g0 + 4 <= rows; g0 += 4) logit_rows<4, RB>(qs, kc, ks, wts, n, Dh, g0, lane, warp);
      if constexpr (RB >= 2)
        for (; g0 + 2 <= rows; g0 += 2) logit_rows<2, RB>(qs, kc, ks, wts, n, Dh, g0, lane, warp);
      for (; g0 < rows; ++g0) logit_rows<1, RB>(qs, kc, ks, wts, n, Dh, g0, lane, warp);
    } else {
      const int sub = tid % I8_LANES;
      for (int base = 0; base < n; base += I8_THREADS / I8_LANES) {
        const int i = base + tid / I8_LANES;
        float acc[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) acc[r] = 0.f;
        if (i < n)
          for (int d = sub; d < Dh; d += I8_LANES) {
            const float c = (float)kc[i * Dh + d];
#pragma unroll
            for (int r = 0; r < RB; ++r) acc[r] = fmaf(qs[r * Dh + d], c, acc[r]);
          }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
        }
        if (i < n && sub == 0) {
          const float sc = ks[i];
#pragma unroll
          for (int r = 0; r < RB; ++r) acc[r] *= sc;
          store_rows<RB>(wts + i * RB, acc);
        }
      }
    }
    __syncthreads();
    if (tid == 0) copy(&bars[1], vc, v8, false);

    // Local softmax over the block's positions, all threads: per-row max m,
    // p = exp(logit - m), l = sum p, each reduced over the warps; the
    // weights become p scale_v, V's scales having landed with its codes.
    float m[RB], l[RB], v[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) m[r] = -INFINITY, l[r] = 0.f;
    for (int i = tid; i < n; i += I8_THREADS) {
      load_rows<RB>(wts + i * RB, v);
#pragma unroll
      for (int r = 0; r < RB; ++r) m[r] = r < rows ? fmaxf(m[r], v[r]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      m[r] = warp_max(m[r]);
      if (lane == 0) red[warp * RB + r] = m[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      m[r] = red[r];
#pragma unroll
      for (int w = 1; w < I8_WARPS; ++w) m[r] = fmaxf(m[r], red[w * RB + r]);
    }
    for (int i = tid; i < n; i += I8_THREADS) {
      load_rows<RB>(wts + i * RB, v);
      const float svi = vs[i];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float p = r < rows ? expf(v[r] - m[r]) : 0.f;
        l[r] += p;
        v[r] = p * svi;
      }
      store_rows<RB>(wts + i * RB, v);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      l[r] = warp_sum(l[r]);
      if (lane == 0) red[(I8_WARPS + warp) * RB + r] = l[r];
    }
    __syncthreads();
    if (tid < RB) {
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < I8_WARPS; ++w) lsum += red[(I8_WARPS + w) * RB + tid];
      float mt = m[0];
#pragma unroll
      for (int r = 1; r < RB; ++r) mt = tid == r ? m[r] : mt;
      m_s[tid] = mt;
      l_s[tid] = lsum;
    }

    // PV, one 64-column chunk at a time: thread (slice, dg) sums columns
    // c0 + 4 dg .. + 3 over positions slice, slice + 8, ..., each position's
    // RB weights read as vectors; a warp reads two neighbouring rows' 64-byte
    // chunks, and a shuffle adds its two slices.
    const int slice = tid >> 4, dg = tid & 15;
    mbar_wait(&bars[1], phase);
    for (int c0 = 0; c0 < Dh; c0 += I8_CHUNK) {
      const int d0 = c0 + dg * 4;
      const int nd = min(4, Dh - d0);  // this thread's columns in the chunk
      float acc[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      if (nd > 0) {
#pragma unroll 2
        for (int i = slice; i < n; i += I8_SLICES) {
          const int8_t* vp = vc + i * Dh + d0;
          float c[4];
          if (kVec) {
            codes4(*reinterpret_cast<const int*>(vp), c);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) c[k] = k < nd ? (float)vp[k] : 0.f;
          }
          load_rows<RB>(wts + i * RB, v);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r < rows) {
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(v[r], c[k], acc[r][k]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[r][k] += __shfl_xor_sync(0xffffffffu, acc[r][k], 16);
          if (warp > 0 && lane < 16)
            part[((warp - 1) * RB + r) * I8_CHUNK + dg * 4 + k] = acc[r][k];
        }
      __syncthreads();
      if (warp == 0 && lane < 16) {
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float sum = acc[r][k];
#pragma unroll
            for (int w = 0; w < I8_WARPS - 1; ++w)
              sum += part[(w * RB + r) * I8_CHUNK + dg * 4 + k];
            if (r < rows && k < nd) acc_s[r * Dh + d0 + k] = sum;
          }
      }
      __syncthreads();  // part is free for the next chunk
    }
    if (tid == 0 && r0 + RB < R) copy(&bars[0], kc, k8, false);  // K again, next pass

    // Merge the S blocks' (m, l, acc) in distributed shared memory: each
    // output of this block's share reads every peer's m, l and acc at once
    // (one round trip), then out = sum_j e^(m_j - M) acc_j / sum_j e^(m_j -
    // M) l_j.  An empty chunk (m = -inf, l = 0, acc = 0) weighs e^-inf = 0.
    cluster.sync();
    const int total = rows * Dh, share = (total + S - 1) / S;
    const int end = min(total, (s + 1) * share);
    for (int i = s * share + tid; i < end; i += I8_THREADS) {
      const int rr = i / Dh, d = i % Dh;
      float mj[I8_MAX_SPLIT], lj[I8_MAX_SPLIT], aj[I8_MAX_SPLIT];
#pragma unroll
      for (int j = 0; j < I8_MAX_SPLIT; ++j) {
        const bool peer = j < S;
        mj[j] = peer ? *cluster.map_shared_rank(m_s + rr, j) : -INFINITY;
        lj[j] = peer ? *cluster.map_shared_rank(l_s + rr, j) : 0.f;
        aj[j] = peer ? *cluster.map_shared_rank(acc_s + i, j) : 0.f;
      }
      float M = mj[0];
#pragma unroll
      for (int j = 1; j < I8_MAX_SPLIT; ++j) M = fmaxf(M, mj[j]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int j = 0; j < I8_MAX_SPLIT; ++j) {
        const float e = expf(mj[j] - M);
        num = fmaf(e, aj[j], num);
        den = fmaf(e, lj[j], den);
      }
      const int r = r0 + rr, g = r / T_new, t = r % T_new;
      out[((size_t)(b * G + g) * T_new + t) * D + h * Dh + d] = num / den;
    }
    cluster.sync();  // the peers have read this pass's m, l and acc
  }
}

// Launch (clusters == nullptr) or, with ``clusters``, only report how many
// clusters of this configuration the card holds at once.
template <typename T, int RB, bool kVec>
int launch_int8_xattn(const T* q, const int8_t* k8, const float* sk, const int8_t* v8,
                      const float* sv, float* out, int B, int G, int T_new, int H, int Tp,
                      int Dh, int t_real, int S, int cs, float scale, cudaStream_t s,
                      int* clusters) {
  auto kernel = int8_xattn_kernel<T, RB, kVec>;
  const int smem = I8Layout(cs, Dh, RB).bytes;
  QASR_TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  cudaLaunchConfig_t cfg = {};  // grid (B H, S) in clusters of (1, S, 1)
  cfg.gridDim = dim3(B * H, S);
  cfg.blockDim = dim3(I8_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  QASR_TRY(cudaLaunchKernelEx(&cfg, kernel, q, k8, sk, v8, sv, out, G, T_new, H, Tp, Dh,
                              t_real, cs, scale));
  return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int run_rows(const T* q, const int8_t* k8, const float* sk, const int8_t* v8,
             const float* sv, float* out, int B, int G, int T_new, int H, int Tp, int Dh,
             int t_real, int S, int cs, float scale, cudaStream_t s, int* clusters) {
  const int R = G * T_new;
  if (R == 1)
    return launch_int8_xattn<T, 1, kVec>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh,
                                         t_real, S, cs, scale, s, clusters);
  if (R <= 4)
    return launch_int8_xattn<T, 4, kVec>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh,
                                         t_real, S, cs, scale, s, clusters);
  return launch_int8_xattn<T, 8, kVec>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh,
                                       t_real, S, cs, scale, s, clusters);
}

template <typename T>
int run_int8_xattn(const T* q, const int8_t* k8, const float* sk, const int8_t* v8,
                   const float* sv, float* out, int B, int G, int T_new, int H, int Tp,
                   int Dh, int t_real, int S, int cs, float scale, cudaStream_t s,
                   int* clusters) {
  if (Dh % 16 == 0)
    return run_rows<T, true>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh, t_real, S, cs,
                             scale, s, clusters);
  return run_rows<T, false>(q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh, t_real, S, cs,
                            scale, s, clusters);
}

}  // namespace qasr

using namespace qasr;

static int int8_entry(int dtype, const void* q, const void* k8, const void* sk,
                      const void* v8, const void* sv, void* out, int B, int G, int T_new, int H,
                      int Tp, int Dh, int t_real, int S, int cs, float scale, void* stream,
                      int* clusters) {
  if (S < 1 || S > I8_MAX_SPLIT || cs % 16 || (long long)S * cs < t_real || Tp % 16 ||
      t_real < 1 || t_real > Tp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int8_t* kc = (const int8_t*)k8;
  const int8_t* vc = (const int8_t*)v8;
  if (dtype == kF32)
    return run_int8_xattn<float>((const float*)q, kc, (const float*)sk, vc, (const float*)sv,
                                 (float*)out, B, G, T_new, H, Tp, Dh, t_real, S, cs, scale, s,
                                 clusters);
  return run_int8_xattn<__nv_bfloat16>((const __nv_bfloat16*)q, kc, (const float*)sk, vc,
                                       (const float*)sv, (float*)out, B, G, T_new, H, Tp, Dh,
                                       t_real, S, cs, scale, s, clusters);
}

// q (B G, T_new, H Dh) in the compute dtype, group-major rows; codes
// (B, H, Tp, Dh) int8 and scales (B, H, Tp) fp32, both 16-byte aligned, Tp a
// multiple of 16; out (B G, T_new, H Dh) fp32; 1 <= t_real <= Tp;
// 1 <= Dh <= 256; the split: 1 <= S <= 8 blocks of cs positions, cs a
// multiple of 16 with S cs >= t_real; scale = Dh^-0.5 in fp32.
extern "C" int qasr_int8_cross_attention(int dtype, const void* q, const void* k8,
                                         const void* sk, const void* v8, const void* sv,
                                         void* out, int B, int G, int T_new, int H, int Tp,
                                         int Dh, int t_real, int S, int cs, float scale,
                                         void* stream) {
  return int8_entry(dtype, q, k8, sk, v8, sv, out, B, G, T_new, H, Tp, Dh, t_real, S, cs,
                    scale, stream, nullptr);
}

// How many clusters of the launch above (S blocks of cs positions, for G
// T_new query rows of head width Dh) the card holds at once, into *clusters.
extern "C" int qasr_int8_cross_attention_clusters(int dtype, int G, int T_new, int Dh,
                                                  int t_real, int S, int cs, void* clusters,
                                                  void* stream) {
  return int8_entry(dtype, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, G, T_new,
                    1, i8_align(t_real, 16), Dh, t_real, S, cs, 1.f, stream, (int*)clusters);
}
