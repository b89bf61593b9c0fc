// Fused decoder-layer step (K10): one cooperative launch per decoder layer per token.
//
// Replaces qasr_ijcnlp_tpu/ops/decoder_step.py `_kernel`.  For B rows of one
// token each: LN -> q/k/v (the fresh k/v written into the self cache at idx)
// -> self-attention over positions 0..idx -> out-proj + residual -> cross
// LN -> q -> cross-attention over the Ta audio positions -> out-proj +
// residual -> LN -> fc -> exact-erf GELU -> proj + residual.  Numerics are
// the reference kernel's: fp32 LN and softmax, every product's inputs in the
// compute dtype T summed in fp32, each product's output rounded to T where
// the reference rounds it; the attention is the reference's chunked softmax:
// per chunk of positions the max m_s, p = exp(logit - m_s), the denominator
// over the unrounded p and PV over p rounded to T, the chunks merged in fp32
// (out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max_s m_s).
// The self q is scaled by 64^-0.5 against the unscaled self K; the cross K
// arrives pre-scaled by 64^-0.25 (rounded to T), so the cross q is scaled by
// 64^-0.25.
//
// Bound on the H100: the bytes of the layer's weights (14 D^2 values), the
// cross K/V (2 B Ta D values) and the self cache, read once: 85 MB at tiny,
// B = 16, f32, 86% of it the cross K/V (25.5 us at 3.35 TB/s).  The
// products are 28 B D^2 FLOP (264 MFLOP at B = 64: 4 us at the 67 TFLOP/s
// of the CUDA cores), under 5% of the bound, so they stay fp32 FMAs on the
// CUDA cores: the tensor cores would buy nothing here, and in f32 they
// would need the 3xTF32 split.  The TPU kernel's grid was (B / 8 batch
// tiles) x (sequential cache chunks); the earlier port of it gave one block
// to each (row, head) of the attentions (96 blocks on 132 SMs at B = 16,
// each streaming 768 KB of cross K/V with scalar loads) and units of 8 rows
// x 8 columns to the products: 115 of its 176 us at B = 16 went to the
// cross-attention phase.  Here one cooperative launch walks eight phases,
// a grid-wide barrier between them, each cut for the 132 SMs:
//
// * Both attentions split over (row, head, chunk) items of C positions
//   (ops/decoder_step.py `attention_split`: C a multiple of 16, up to 32 KB
//   of K rows, 128 positions in f32 and 256 in bf16; 1,152 cross items at
//   B = 16 in f32).  An item leaves (m_s, l_s, acc_s[64]); a chunk with no
//   visible position gives m = -inf, l = 0, acc = 0.  The merge is folded
//   into the fill of the out-projection that follows (phases 3 and 6), so
//   it needs no barrier of its own.  A block takes a contiguous run of
//   cross items and merges consecutive chunks of one (row, head) as it
//   goes, so the fill reads two or three partials a (row, head), not 12:
//   without that merge phase 6 took 15.6 us, not 7.0, at B = 16 f32 and
//   22.0, not 8.3, at B = 64 (same stamps, same card).
// * Cross K/V chunks (contiguous C x 64 runs of the (B, H, Ta, 64) cache)
//   reach shared memory by 1D bulk copies on mbarriers, in a ring of three
//   stages: a block's next items are in flight while it computes one.
//   Nothing in the kernel writes the cross cache.  Self K/V are read with
//   plain 16-byte loads: phase 1 wrote the fresh k/v at idx with generic
//   stores from other blocks, which a bulk copy (the async proxy) could only
//   read after a proxy fence.
// * Warp specialisation: a bulk copy can hold the thread that issues it
//   until the memory system takes it (a compute thread issuing the ring's
//   copies waited 8-10 us before its block's first item), so a producer
//   warpgroup's lane issues every copy, on full / empty mbarrier pairs, and
//   two warpgroups compute, on a named barrier of their own.  setmaxnreg
//   moves registers from the producer (40) to the compute warps (232): a
//   384-thread block starts at 168 a thread, and without the move the
//   kernel spilled and ran 11-29% slower (tiny, B = 16 and 64, f32 and
//   bf16: 72.6 -> 87.9 us at B = 16 f32; diagnostics/decoder_step_stamps,
//   H100 80GB HBM3 at 700 W).
// * In an item, 8 lanes share a position's 64 values (16-byte vectors,
//   conflict-free, summed by shuffles) for the logits; PV runs over 16-byte
//   vectors of V rows, position slices summed by shuffles and through
//   shared memory.
// * A product unit is (a row tile of TR = 8 or 16 rows) x (a slab of NS =
//   8 TN output columns): its weight slab, one contiguous run of the (N, K)
//   weight, arrives by one bulk copy while the compute warps stage the
//   tile's input in shared memory once (LayerNorm applied once per row,
//   with fp32 statistics, rounded to T; or the attention merge; or proj's
//   rows), so each weight element is read once per row tile.  Each warp
//   sums TN columns for all TR rows, its lanes on neighbouring k (16-byte
//   reads of the fp32 input, 16 / 8 bytes of the weight), and a
//   reduce-scatter over the lanes leaves each lane one finished output.
//   The shape (`pick_shape`) takes the fewest rounds of units over the
//   grid, then the most units, then the widest slab, within the shared
//   memory.  Larger tiles (32 or 64 rows, or 64 outputs a lane) spilled
//   registers and ran slower.
// * The launch configuration (shared-memory attribute, co-resident block
//   count) is computed once per device and dtype; the grid is that count.
#include <algorithm>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace qasr {

constexpr int DS_THREADS = 256;             // the compute warps: two warpgroups
constexpr int DS_WARPS = DS_THREADS / 32;
constexpr int DS_BLOCK = DS_THREADS + 128;  // and a producer warpgroup
// Registers a thread of each role keeps (setmaxnreg): 8 x 232 + 4 x 40
// warps' worth fit the SM's 64 K.
constexpr int DS_COMPUTE_REGS = 232, DS_PRODUCER_REGS = 40;
constexpr int DS_DH = 64;
constexpr int DS_CHUNK_BYTES = 32768;  // an attention item's K rows, at most
constexpr int DS_MAX_CHUNK = 256;      // its positions, at most (bf16)
constexpr int DS_STAGES = 3;
constexpr int DS_MAX_D = 512;      // tiny and base widths
// Positions of an attention item of T, at most: 128 f32, 256 bf16.
template <typename T>
__host__ __device__ constexpr int max_chunk() {
  return DS_CHUNK_BYTES / (DS_DH * (int)sizeof(T));
}
// The shared region that each phase uses in its own way: the cross ring
// (3 stages of a K and a V chunk), a self chunk, or a product unit's input
// tile, weight slab and merge scratch.
constexpr int DS_UNION = DS_STAGES * 2 * DS_CHUNK_BYTES;  // 196,608 bytes
// q [64], logits [256], reductions [16], PV partials [8][64]; then the
// ring's mbarriers and the weight slab's.
constexpr int DS_SMALL = 64 + DS_MAX_CHUNK + 16 + DS_WARPS * DS_DH;
// The mbarriers: the ring's full and empty, the weight slab's full and empty.
constexpr int DS_BARS = 2 * DS_STAGES + 2;
constexpr int DS_SMEM = DS_UNION + 4 * DS_SMALL + 8 * DS_BARS;

// A barrier of the compute warps alone (the producer warpgroup never waits on it).
__device__ __forceinline__ void csync() { named_bar(1, DS_THREADS); }

enum Phase : int { kQkv = 0, kOut, kCrossQ, kCrossOut, kFc, kProj, kProducts };

// Product unit shapes (TR rows, TN columns a warp); NS = 8 TN columns a unit.
struct UnitShape {
  int tr, tn;
};
constexpr int kNumShapes = 4;
constexpr UnitShape kShapes[kNumShapes] = {{8, 2}, {8, 4}, {16, 1}, {16, 2}};

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
  float* work;       // phase outputs and attention partials (_work_floats)
  int B, D, H, ctx, Ta, idx;
  int cs, ss;        // self attention: positions a chunk, chunks
  int cx, sx;        // cross attention
  int shape[kProducts];  // unit shape of each product phase
};

// Pointers into the packed weights and the work buffer.
template <typename T>
struct Layer {
  const StepArgs<T>& a;  // the kernel's __grid_constant__ parameter
  const T *wqkv, *wo, *wcq, *wco, *wf, *wp, *bqkv, *bo, *bcq, *bco, *bf, *bp;
  float *qs, *qc, *xmid, *x2, *tt, *sacc, *sml, *xacc, *xml;
  __device__ explicit Layer(const StepArgs<T>& args) : a(args) {
    const int B = a.B, D = a.D, H = a.H;
    const size_t BD = (size_t)B * D, DD = (size_t)D * D, FD = 4 * DD;
    wqkv = a.w;
    wo = wqkv + 3 * DD;
    wcq = wo + DD;
    wco = wcq + DD;
    wf = wco + DD;
    wp = wf + FD;
    bqkv = wp + FD;
    bo = bqkv + 3 * D;
    bcq = bo + D;
    bco = bcq + D;
    bf = bco + D;
    bp = bf + 4 * D;
    qs = a.work;
    qc = qs + BD;
    xmid = qc + BD;
    x2 = xmid + BD;
    tt = x2 + BD;             // (B, 4D)
    sacc = tt + 4 * BD;       // (B H ss, 64)
    sml = sacc + (size_t)B * H * a.ss * DS_DH;  // (B H ss, 2): m, l
    xacc = sml + (size_t)B * H * a.ss * 2;      // (B H sx, 64)
    xml = xacc + (size_t)B * H * a.sx * DS_DH;  // (B H sx, 2)
  }
};

// The 16 bytes at p (4 f32 or 8 bf16 values) as floats.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void bf16x2(uint32_t u, float* v) {
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  bf16x2(t.x, v), bf16x2(t.y, v + 2), bf16x2(t.z, v + 4), bf16x2(t.w, v + 6);
}
// Four values of T at p (16 bytes of f32, 8 of bf16) as floats.
__device__ __forceinline__ void load4(const float* p, float* v) { load16(p, v); }
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  bf16x2(t.x, v), bf16x2(t.y, v + 2);
}

// dst[i] = src[i] (global -> shared) for the n 16-byte vectors of a run
// (i < n0 from src0, then from src1), by all threads with eight loads in
// flight each: a phase's fill is a few round trips to L2, not one a vector.
__device__ __forceinline__ void stage16(int4* dst, const int4* src0, int n0, const int4* src1,
                                        int n) {
  for (int base = threadIdx.x; base < n; base += 8 * DS_THREADS) {
    int4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * DS_THREADS;
      if (i < n) v[u] = i < n0 ? src0[i] : src1[i - n0];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = base + u * DS_THREADS;
      if (i < n) dst[i] = v[u];
    }
  }
}

// ---------------------------------------------------------------------------
// Attention items
// ---------------------------------------------------------------------------

// One item: q (64 floats in qsm, published by a barrier) against the n
// positions of one chunk, K and V rows of 64 T in shared memory -> the
// chunk's max m (every thread), l = sum exp(logit - m) and acc[d] = sum T(p)
// V[d] (thread d < 64: acc[d], and l).  A chunk without positions gives m =
// -inf, l = 0, acc = 0.  Ends before its callers' barrier, which must
// precede any reuse of qsm, lg, red and part.
template <typename T>
__device__ void attend_chunk(const float* qsm, const T* Ks, const T* Vs, int n, float* lg,
                             float* red, float* part, float& m_out, float& l_out,
                             float& acc_out) {
  constexpr int VL = 16 / sizeof(T);  // values in a 16-byte vector
  constexpr int NV = DS_DH / VL / 8;  // vectors a lane takes of a position (8 lanes)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, sub = tid & 7;
  float qr[NV][VL];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VL; ++e) qr[v][e] = qsm[(sub + 8 * v) * VL + e];
  // Logits: 8 lanes a position; a quarter-warp reads one position's 16-byte
  // vectors side by side (no bank conflict).
  float mloc = -INFINITY;
  for (int i0 = 0; i0 < n; i0 += DS_THREADS / 8) {
    const int i = i0 + (tid >> 3);
    float s = 0.f;
    if (i < n) {
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float kv[VL];
        load16(Ks + i * DS_DH + (sub + 8 * v) * VL, kv);
#pragma unroll
        for (int e = 0; e < VL; ++e) s = fmaf(qr[v][e], kv[e], s);
      }
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (i < n) {
      mloc = fmaxf(mloc, s);
      if (sub == 0) lg[i] = s;
    }
  }
  mloc = warp_max(mloc);
  if (lane == 0) red[warp] = mloc;
  csync();  // publishes the logits and the warps' maxima
  float m = red[0];
#pragma unroll
  for (int w = 1; w < DS_WARPS; ++w) m = fmaxf(m, red[w]);
  float l = 0.f;
  for (int i = tid; i < n; i += DS_THREADS) {
    const float p = expf(lg[i] - m);
    l += p;
    lg[i] = rnd<T>(p);
  }
  l = warp_sum(l);
  if (lane == 0) red[DS_WARPS + warp] = l;
  csync();  // publishes the rounded p
  // PV: LPR lanes cover a V row in 16-byte vectors; the block's SL position
  // slices are summed by shuffles in a warp, then through shared memory.
  constexpr int LPR = DS_DH / VL;
  constexpr int SL = DS_THREADS / LPR;
  const int dg = tid % LPR, slice = tid / LPR;
  float acc[VL];
#pragma unroll
  for (int e = 0; e < VL; ++e) acc[e] = 0.f;
#pragma unroll 2
  for (int i = slice; i < n; i += SL) {
    const float p = lg[i];
    float vv[VL];
    load16(Vs + i * DS_DH + dg * VL, vv);
#pragma unroll
    for (int e = 0; e < VL; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
  }
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < VL; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (lane < LPR)
#pragma unroll
    for (int e = 0; e < VL; ++e) part[warp * DS_DH + dg * VL + e] = acc[e];
  csync();
  m_out = m;
  if (tid < DS_DH) {
    float s = part[tid], lsum = red[DS_WARPS];
#pragma unroll
    for (int w = 1; w < DS_WARPS; ++w) {
      s += part[w * DS_DH + tid];
      lsum += red[DS_WARPS + w];
    }
    acc_out = s;
    l_out = lsum;
  }
}

// Phase 2: items (b, h, s) over positions [s cs, min(idx + 1, (s + 1) cs))
// of the self cache, read with plain 16-byte loads into the shared region.
template <typename T>
__device__ void self_attention(const Layer<T>& L, unsigned char* U, float* qsm, float* lg,
                               float* red, float* part) {
  const StepArgs<T>& a = L.a;
  const int S = a.ss, C = a.cs, tv = a.idx + 1, tid = threadIdx.x;
  T* Ks = reinterpret_cast<T*>(U);
  const int items = a.B * a.H * S;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int bh = it / S, s = it % S, b = bh / a.H, h = bh % a.H;
    const int t0 = min(s * C, tv), n = min(tv, t0 + C) - t0;
    const float q = tid < DS_DH ? L.qs[(size_t)b * a.D + h * DS_DH + tid] : 0.f;
    csync();  // the previous item (or phase) is done with the shared region
    // The chunk's K rows, then its V rows right after them, in one pass.
    const size_t off = ((size_t)bh * a.ctx + t0) * DS_DH;
    const int nvec = n * DS_DH * (int)sizeof(T) / 16;
    stage16(reinterpret_cast<int4*>(Ks), reinterpret_cast<const int4*>(a.self_k + off), nvec,
            reinterpret_cast<const int4*>(a.self_v + off), 2 * nvec);
    if (tid < DS_DH) qsm[tid] = q;
    csync();
    float m, l, acc;
    attend_chunk<T>(qsm, Ks, Ks + n * DS_DH, n, lg, red, part, m, l, acc);
    if (tid < DS_DH) L.sacc[(size_t)it * DS_DH + tid] = acc;
    if (tid == 0) reinterpret_cast<float2*>(L.sml)[it] = make_float2(m, l);
  }
}

// Phase 5: items (b, h, s) over audio positions [s cx, min(Ta, (s + 1) cx)).
// A block takes a contiguous run of items (consecutive chunks of a (b, h),
// mostly); its items j = 0, 1, ... go round the ring of DS_STAGES stages.
// The producer lane lands item j's K and V chunks by two 1D bulk copies on
// full[j % DS_STAGES] once the compute warps have released the stage's
// previous item on empty[j % DS_STAGES]; a copy may hold its issuing thread
// until the memory system takes it, so no compute warp issues one.
struct CrossRun {
  int lo, mine;  // the block's first item and its count
  __device__ CrossRun(int items) {
    lo = (int)((long long)blockIdx.x * items / gridDim.x);
    mine = (int)((long long)(blockIdx.x + 1) * items / gridDim.x) - lo;
  }
};

template <typename T>
__device__ void cross_produce(const Layer<T>& L, unsigned char* U, uint64_t* full,
                              uint64_t* empty) {
  constexpr int stage_elems = 2 * max_chunk<T>() * DS_DH;  // K, then V
  const StepArgs<T>& a = L.a;
  const int S = a.sx, C = a.cx;
  const CrossRun run(a.B * a.H * S);
  for (int j = 0; j < run.mine; ++j) {
    const int st = j % DS_STAGES, it = run.lo + j, bh = it / S, s = it % S;
    const int t0 = min(s * C, a.Ta), n = min(a.Ta, t0 + C) - t0;
    if (j >= DS_STAGES) mbar_wait(&empty[st], (j / DS_STAGES - 1) & 1);
    // The compute warps' generic accesses of the stage (and, for the first
    // items, of the region in phases 1-4) precede the copy.
    fence_proxy_async();
    if (n == 0) {
      mbar_arrive(&full[st]);
      continue;
    }
    T* dst = reinterpret_cast<T*>(U) + st * stage_elems;
    const int bytes = n * DS_DH * (int)sizeof(T);
    const size_t off = ((size_t)bh * a.Ta + t0) * DS_DH;
    mbar_expect_tx(&full[st], 2 * bytes);
    bulk_load(dst, a.cross_k + off, bytes, &full[st]);
    bulk_load(dst + max_chunk<T>() * DS_DH, a.cross_v + off, bytes, &full[st]);
  }
}

// The compute warps' side.  The block merges the chunks of one (b, h) as it
// goes (the same fp32 merge as the next phase's: M = max(m, m_s), weights
// e^(m - M) and e^(m_s - M)) and writes one partial for them, at the run's
// first chunk; the run's other chunks record m = -inf, l = 0 (weight 0).
template <typename T>
__device__ void cross_consume(const Layer<T>& L, unsigned char* U, float* qsm, float* lg,
                              float* red, float* part, uint64_t* full, uint64_t* empty) {
  constexpr int stage_elems = 2 * max_chunk<T>() * DS_DH;
  const StepArgs<T>& a = L.a;
  const int S = a.sx, C = a.cx, tid = threadIdx.x;
  const CrossRun run(a.B * a.H * S);
  // q of item j (a (b, h) row slice): loaded during item j - 1.
  auto q_of = [&](int j) {
    const int bh = (run.lo + j) / S;
    return L.qc[(size_t)(bh / a.H) * a.D + (bh % a.H) * DS_DH + tid];
  };
  float qn = tid < DS_DH && run.mine > 0 ? q_of(0) : 0.f;
  float rm = -INFINITY, rl = 0.f, racc = 0.f;  // the run's merge so far
  int first = run.lo;                          // the run's first item
  for (int j = 0; j < run.mine; ++j) {
    const int st = j % DS_STAGES, it = run.lo + j, s = it % S;
    const int t0 = min(s * C, a.Ta), n = min(a.Ta, t0 + C) - t0;
    if (tid < DS_DH) qsm[tid] = qn;
    csync();  // publishes q
    if (tid < DS_DH && j + 1 < run.mine) qn = q_of(j + 1);
    mbar_wait(&full[st], (j / DS_STAGES) & 1);
    const T* Ks = reinterpret_cast<const T*>(U) + st * stage_elems;
    float m, l, acc;
    attend_chunk<T>(qsm, Ks, Ks + max_chunk<T>() * DS_DH, n, lg, red, part, m, l, acc);
    const bool last = j + 1 == run.mine || s + 1 == S;  // the run ends with this item
    if (tid < DS_DH) {
      const float M = fmaxf(rm, m);
      const float fr = M == -INFINITY ? 0.f : expf(rm - M);
      const float fs = M == -INFINITY ? 0.f : expf(m - M);
      racc = racc * fr + acc * fs;
      rl = rl * fr + l * fs;
      rm = M;
      if (last) {
        L.xacc[(size_t)first * DS_DH + tid] = racc;
        if (tid == 0) reinterpret_cast<float2*>(L.xml)[first] = make_float2(rm, rl);
        rm = -INFINITY, rl = 0.f, racc = 0.f;
      }
      if (tid == 0 && it != first)
        reinterpret_cast<float2*>(L.xml)[it] = make_float2(-INFINITY, 0.f);
    }
    if (last) first = it + 1;
    csync();  // the block is done with the stage, q, the logits and the partials
    if (tid == 0) mbar_arrive(&empty[st]);
  }
}

// ---------------------------------------------------------------------------
// Products
// ---------------------------------------------------------------------------

// Input tile: rows r0 .. r0 + TR - 1 of src (B, D) through an fp32
// LayerNorm, rounded to T, into As [TR][D] (rows >= B zero).  The rows are
// staged raw in one pass (bf16 ones through registers), then each warp
// normalises rows in place, the LN parameters of its lanes' columns held in
// registers (D <= 512: 16 a lane).
template <typename T, typename S>
__device__ void ln_fill(const S* src, const float* g, const float* bta, int D, int B, int r0,
                        int TR, float* As) {
  constexpr int NK = DS_MAX_D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nr = max(0, min(TR, B - r0));
  float gk[NK], bk[NK];
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int k = lane + 32 * i;
    gk[i] = k < D ? g[k] : 0.f;
    bk[i] = k < D ? bta[k] : 0.f;
  }
  if constexpr (sizeof(S) == 4) {
    const int n = nr * D / 4;
    stage16(reinterpret_cast<int4*>(As), reinterpret_cast<const int4*>(src + (size_t)r0 * D), n,
            nullptr, n);
  } else {
    const int n = nr * D / 8;  // 16-byte vectors of 8 bf16 -> 32 bytes of fp32
    const int4* s4 = reinterpret_cast<const int4*>(src + (size_t)r0 * D);
    for (int base = threadIdx.x; base < n; base += 4 * DS_THREADS) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (base + u * DS_THREADS < n) v[u] = s4[base + u * DS_THREADS];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * DS_THREADS;
        if (i >= n) continue;
        float f[8];
        bf16x2((uint32_t)v[u].x, f), bf16x2((uint32_t)v[u].y, f + 2);
        bf16x2((uint32_t)v[u].z, f + 4), bf16x2((uint32_t)v[u].w, f + 6);
        float4* d = reinterpret_cast<float4*>(As) + 2 * i;
        d[0] = make_float4(f[0], f[1], f[2], f[3]);
        d[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  }
  for (int i = threadIdx.x + nr * D; i < TR * D; i += DS_THREADS) As[i] = 0.f;
  csync();
  for (int r = warp; r < nr; r += DS_WARPS) {
    float* row = As + (size_t)r * D;
    float v[NK];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int k = lane + 32 * i;
      v[i] = k < D ? row[k] : 0.f;
      sum += v[i];
    }
    const float mean = warp_sum(sum) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const float d = lane + 32 * i < D ? v[i] - mean : 0.f;
      q = fmaf(d, d, q);
    }
    const float rstd = rsqrtf(warp_sum(q) / D + 1e-5f);
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      const int k = lane + 32 * i;
      if (k < D) row[k] = rnd<T>((v[i] - mean) * rstd * gk[i] + bk[i]);
    }
  }
}

// Input tile: the attention output of rows r0 .. r0 + TR - 1, merged from
// the S chunk partials of each (row, head): M = max_s m_s, out[d] =
// T(sum_s e^(m_s - M) acc_s[d] / sum_s e^(m_s - M) l_s).  A partial of
// weight 0 (an empty chunk, or one the cross phase merged into its run's
// first) is not read: a thread a (row, head) lists the others in scr
// (count, denominator, then (s, e^(m_s - M)) pairs; merge_scratch floats),
// then each thread's two column groups of the tile load their first two
// listed partials at once.
__host__ __device__ constexpr int merge_scratch(int S) { return 2 * S + 2; }

template <typename T>
__device__ void merge_fill(const float* acc, const float* ml, int S, int H, int B, int r0, int TR,
                           float* As, float* scr) {
  constexpr int MB = 16, QB = 2;
  const int D = H * DS_DH, tid = threadIdx.x;
  for (int p = tid; p < TR * H; p += DS_THREADS) {
    const int r = p / H, h = p % H, row = r0 + r;
    float* list = scr + p * merge_scratch(S);
    int cnt = 0;
    float den = 0.f;
    if (row < B) {
      const float2* m = reinterpret_cast<const float2*>(ml) + (size_t)(row * H + h) * S;
      float M = -INFINITY;
      float2 v[MB];  // S <= MB partials are loaded once, for both passes
      for (int pass = 0; pass < 2; ++pass)
        for (int s0 = 0; s0 < S; s0 += MB) {
          if (pass == 0 || S > MB) {
#pragma unroll
            for (int u = 0; u < MB; ++u)
              if (s0 + u < S) v[u] = m[s0 + u];
          }
#pragma unroll
          for (int u = 0; u < MB; ++u) {
            if (s0 + u >= S) continue;
            if (pass == 0) {
              M = fmaxf(M, v[u].x);
              continue;
            }
            const float es = expf(v[u].x - M);  // 0 for an empty chunk (m = -inf)
            if (es == 0.f) continue;
            den = fmaf(es, v[u].y, den);
            list[2 + 2 * cnt] = __int_as_float(s0 + u);
            list[3 + 2 * cnt] = es;
            ++cnt;
          }
        }
    }
    list[0] = __int_as_float(cnt);
    list[1] = den;
  }
  csync();
  const int groups = D / 4, ntask = TR * groups;  // (row, 4 columns)
  for (int base = tid; base < ntask; base += QB * DS_THREADS) {
    float4 v[QB][2];
    const float* lists[QB];
    const float4* srcs[QB];
    int cnts[QB];
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const int task = base + q * DS_THREADS, r = task / groups, c = 4 * (task % groups);
      const int h = c / DS_DH, row = r0 + r;
      cnts[q] = 0;
      if (task < ntask && row < B) {
        lists[q] = scr + (r * H + h) * merge_scratch(S);
        srcs[q] = reinterpret_cast<const float4*>(acc + (size_t)(row * H + h) * S * DS_DH +
                                                  c % DS_DH);
        cnts[q] = __float_as_int(lists[q][0]);
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (k < cnts[q]) v[q][k] = srcs[q][(size_t)__float_as_int(lists[q][2 + 2 * k]) * 16];
      }
    }
#pragma unroll
    for (int q = 0; q < QB; ++q) {
      const int task = base + q * DS_THREADS;
      if (task >= ntask) continue;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cnts[q] > 0) {
        float4 num = o;
        for (int k = 0; k < cnts[q]; ++k) {
          const float es = lists[q][3 + 2 * k];
          const float4 x =
              k < 2 ? v[q][k] : srcs[q][(size_t)__float_as_int(lists[q][2 + 2 * k]) * 16];
          num.x = fmaf(es, x.x, num.x);
          num.y = fmaf(es, x.y, num.y);
          num.z = fmaf(es, x.z, num.z);
          num.w = fmaf(es, x.w, num.w);
        }
        const float den = lists[q][1];
        o = make_float4(rnd<T>(num.x / den), rnd<T>(num.y / den), rnd<T>(num.z / den),
                        rnd<T>(num.w / den));
      }
      reinterpret_cast<float4*>(As)[task] = o;
    }
  }
}

// Input tile: rows r0 .. r0 + TR - 1 of a phase output (B, K) as stored.
__device__ void row_fill(const float* src, int K, int B, int r0, int TR, float* As) {
  const int nr = max(0, min(TR, B - r0)), n = nr * K / 4;
  stage16(reinterpret_cast<int4*>(As), reinterpret_cast<const int4*>(src + (size_t)r0 * K), n,
          nullptr, n);
  for (int i = threadIdx.x + nr * K; i < TR * K; i += DS_THREADS) As[i] = 0.f;
}

// The input tile of product phase `ph` for rows r0 .. r0 + TR - 1.
template <typename T>
__device__ __forceinline__ void fill(const Layer<T>& L, int ph, int r0, int TR, float* As,
                                     float* scr) {
  const StepArgs<T>& a = L.a;
  const int B = a.B, D = a.D;
  const float* ln = a.ln;
  switch (ph) {
    case kQkv: ln_fill<T, T>(a.x, ln, ln + D, D, B, r0, TR, As); break;
    case kOut: merge_fill<T>(L.sacc, L.sml, a.ss, a.H, B, r0, TR, As, scr); break;
    case kCrossQ: ln_fill<T, float>(L.xmid, ln + 2 * D, ln + 3 * D, D, B, r0, TR, As); break;
    case kCrossOut: merge_fill<T>(L.xacc, L.xml, a.sx, a.H, B, r0, TR, As, scr); break;
    case kFc: ln_fill<T, float>(L.x2, ln + 4 * D, ln + 5 * D, D, B, r0, TR, As); break;
    default: row_fill(L.tt, 4 * D, B, r0, TR, As);
  }
}

// Reduce-scatter of O partial sums across the 32 lanes: step ST keeps half
// of the values and adds the partner lane's (lane ^ (16 >> ST)) copy of that
// half.  After the five steps v[0 .. O / 32) (O >= 32) hold the totals of
// outputs lane O / 32 + j; with O < 32, v[0] holds output lane / (32 / O),
// in 32 / O lanes.
template <int O, int ST = 0>
__device__ __forceinline__ void lane_reduce(float* v, int lane) {
  if constexpr (ST < 5) {
    constexpr int o = 16 >> ST, c = O >> ST;
    if constexpr (c >= 2) {
      const bool up = lane & o;
#pragma unroll
      for (int i = 0; i < c / 2; ++i) {
        const float send = up ? v[i] : v[i + c / 2];
        const float keep = up ? v[i + c / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
    lane_reduce<O, ST + 1>(v, lane);
  }
}

// The epilogue's operands of output (b, n), loaded before the sums: the
// bias and, for a residual, the row's stream value.
template <typename T>
__device__ __forceinline__ float2 epilogue_operands(const Layer<T>& L, int ph, int b, int n) {
  const StepArgs<T>& a = L.a;
  const size_t i = (size_t)b * a.D + n;
  switch (ph) {
    case kQkv: return make_float2(to_f(L.bqkv[n]), 0.f);
    case kOut: return make_float2(to_f(L.bo[n]), to_f(a.x[i]));
    case kCrossQ: return make_float2(to_f(L.bcq[n]), 0.f);
    case kCrossOut: return make_float2(to_f(L.bco[n]), L.xmid[i]);
    case kFc: return make_float2(to_f(L.bf[n]), 0.f);
    default: return make_float2(to_f(L.bp[n]), L.x2[i]);  // kProj
  }
}

template <typename T>
__device__ __forceinline__ void epilogue(const Layer<T>& L, int ph, int b, int n, float acc,
                                         float2 op) {
  const StepArgs<T>& a = L.a;
  const int D = a.D;
  const size_t i = (size_t)b * D + n;
  const float y = acc + op.x;
  switch (ph) {
    case kQkv: {
      if (n < D) {
        L.qs[i] = rnd<T>(y * 0.125f);  // 64^-0.5
      } else {
        const int c = n % D, h = c / DS_DH, d = c % DS_DH;
        T* cache = n < 2 * D ? a.self_k : a.self_v;
        cache[(((size_t)b * a.H + h) * a.ctx + a.idx) * DS_DH + d] = from_f<T>(y);
      }
      break;
    }
    case kOut: L.xmid[i] = rnd<T>(op.y + rnd<T>(y)); break;
    case kCrossQ: L.qc[i] = rnd<T>(y * 0.35355339059327373f); break;  // 64^-0.25
    case kCrossOut: L.x2[i] = rnd<T>(op.y + rnd<T>(y)); break;
    case kFc: L.tt[(size_t)b * 4 * D + n] = rnd<T>(gelu_erf(y)); break;
    default: a.out[i] = from_f<T>(op.y + rnd<T>(y));  // kProj
  }
}

// The sums of one unit: warp w takes columns n0 + w TN + j (j < TN), its
// lanes k = 4 lane + 128 i, for all TR rows of the tile in As; a
// reduce-scatter over the lanes, then the epilogue with the operands `op`
// loaded before (this lane's outputs, as `unit_outputs` lists them).
template <typename T, int TR, int TN>
__device__ __forceinline__ void unit_sums(const Layer<T>& L, int ph, const float* As,
                                          const T* Ws, int K, int r0, int n0, const float2* op) {
  constexpr int O = TR * TN, HELD = O >= 32 ? O / 32 : 1, SPREAD = O >= 32 ? 1 : 32 / O;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[O];
#pragma unroll
  for (int i = 0; i < O; ++i) acc[i] = 0.f;
  const T* wr = Ws + (size_t)warp * TN * K;
  for (int k = 4 * lane; k < K; k += 128) {
    float wv[TN][4];
#pragma unroll
    for (int j = 0; j < TN; ++j) load4(wr + (size_t)j * K + k, wv[j]);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      float av[4];
      load16(As + (size_t)r * K + k, av);
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r * TN + j] = fmaf(av[e], wv[j][e], acc[r * TN + j]);
    }
  }
  lane_reduce<O>(acc, lane);
#pragma unroll
  for (int j = 0; j < HELD; ++j) {
    const int idx = O >= 32 ? lane * HELD + j : lane / SPREAD;
    const int row = r0 + idx / TN, n = n0 + warp * TN + idx % TN;
    if (lane % SPREAD == 0 && row < L.a.B) epilogue(L, ph, row, n, acc[j], op[j]);
  }
}

// A product phase `ph`: N columns, K deep, weight W (N, K) row-major in T;
// units of TR rows x NS = 8 TN columns (the phase's shape, `pick_shape`) go
// round the grid.
template <typename T>
struct ProductPlan {
  int sid, TR, TN, N, K, NS, slabs, units;
  const T* W;
  __device__ ProductPlan(const Layer<T>& L, int ph) {
    const int D = L.a.D;
    sid = L.a.shape[ph];
    TR = sid < 2 ? 8 : 16;  // kShapes
    TN = sid < 2 ? 2 << sid : 1 << (sid - 2);
    N = ph == kQkv ? 3 * D : ph == kFc ? 4 * D : D;
    K = ph == kProj ? 4 * D : D;
    W = ph == kQkv ? L.wqkv : ph == kOut ? L.wo : ph == kCrossQ ? L.wcq
      : ph == kCrossOut ? L.wco : ph == kFc ? L.wf : L.wp;
    NS = DS_WARPS * TN;
    slabs = N / NS;
    units = (L.a.B + TR - 1) / TR * slabs;
  }
};

// The producer lane: each unit's weight slab, one contiguous run of W, by
// one bulk copy on wfull into the region after the input tile, once the
// compute warps have released the previous slab on wempty.  `wuse` counts
// the slabs of the launch so far, as the compute warps count them.
template <typename T>
__device__ void product_produce(const Layer<T>& L, int ph, unsigned char* U, uint64_t* wfull,
                                uint64_t* wempty, int& wuse) {
  const ProductPlan<T> P(L, ph);
  T* Ws = reinterpret_cast<T*>(U + (size_t)P.TR * P.K * 4);
  const int bytes = P.NS * P.K * (int)sizeof(T);
  for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++wuse) {
    if (wuse > 0) mbar_wait(wempty, (wuse - 1) & 1);
    fence_proxy_async();  // the compute warps' reads of the region precede the copy
    mbar_expect_tx(wfull, bytes);
    bulk_load(Ws, P.W + (size_t)(u % P.slabs) * P.NS * P.K, bytes, wfull);
  }
}

// The compute warps: out(b, n) = ep(b, n, sum_k A[b, k] W[n, k]) for the
// units of this block.
template <typename T>
__device__ void product_consume(const Layer<T>& L, int ph, unsigned char* U, uint64_t* wfull,
                                uint64_t* wempty, int& wuse) {
  const ProductPlan<T> P(L, ph);
  const int B = L.a.B, K = P.K, TR = P.TR, TN = P.TN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // This lane's outputs after the reduction: HELD of them, each held by
  // SPREAD lanes.
  const int O = TR * TN, HELD = O >= 32 ? O / 32 : 1, SPREAD = O >= 32 ? 1 : 32 / O;
  float* As = reinterpret_cast<float*>(U);                        // [TR][K] fp32
  const T* Ws = reinterpret_cast<const T*>(U + (size_t)TR * K * 4);  // [NS][K]
  float* scr = reinterpret_cast<float*>(U + (size_t)TR * K * 4 + (size_t)P.NS * K * sizeof(T));
  int staged = -1;
  for (int u = blockIdx.x; u < P.units; u += gridDim.x, ++wuse) {
    const int tile = u / P.slabs, n0 = (u % P.slabs) * P.NS, r0 = tile * TR;
    float2 op[2];  // the epilogue operands, in flight during the fill
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = O >= 32 ? lane * HELD + j : lane / SPREAD;
      const int row = r0 + idx / TN, n = n0 + warp * TN + idx % TN;
      op[j] = j < HELD && row < B ? epilogue_operands(L, ph, row, n) : make_float2(0.f, 0.f);
    }
    if (tile != staged) {  // the weight slab lands meanwhile
      csync();             // the previous unit is done with the input tile
      staged = tile;
      fill<T>(L, ph, r0, TR, As, scr);
      csync();
    }
    mbar_wait(wfull, wuse & 1);
    switch (P.sid) {
      case 0: unit_sums<T, 8, 2>(L, ph, As, Ws, K, r0, n0, op); break;
      case 1: unit_sums<T, 8, 4>(L, ph, As, Ws, K, r0, n0, op); break;
      case 2: unit_sums<T, 16, 1>(L, ph, As, Ws, K, r0, n0, op); break;
      default: unit_sums<T, 16, 2>(L, ph, As, Ws, K, r0, n0, op);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(wempty);  // this warp is done with the slab
  }
}

template <typename T>
__global__ void __launch_bounds__(DS_BLOCK, 1)
    decoder_layer_kernel(const __grid_constant__ StepArgs<T> args) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  unsigned char* U = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DS_UNION + 4 * DS_SMALL);
  uint64_t* empty = full + DS_STAGES;
  uint64_t* wfull = empty + DS_STAGES;
  uint64_t* wempty = wfull + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < DS_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    mbar_init(wfull, 1);
    mbar_init(wempty, DS_WARPS);
    mbar_init_fence();
  }
  __syncthreads();
  // The eight phases, a grid barrier between each two:
  //   0. LN + q/k/v; the fresh k and v go into the self cache at idx
  //   1. self-attention over positions 0..idx
  //   2. merge + out-proj + residual
  //   3. cross LN + q
  //   4. cross-attention over the Ta audio positions
  //   5. merge + out-proj + residual
  //   6. LN + fc + GELU
  //   7. proj + residual
  // Phase outputs are fp32 (values already rounded to T); none of them, nor
  // the self cache, is read in a phase before the barrier after its writes.
  // Every thread of every block reaches every barrier: no early return.
  // Warpgroup 2 produces (lane 0 of warp 8 issues every bulk copy: a copy
  // can hold its issuing thread until the memory system takes it); warps
  // 0-7 compute.  Each role has its own loop over the phases, one call
  // site for each kind of phase, and its own register budget.
  int wuse = 0;  // weight slabs used so far, counted alike by both roles
  if (threadIdx.x >= DS_THREADS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(DS_PRODUCER_REGS));
    const Layer<T> L(args);
    const bool issuer = threadIdx.x == DS_THREADS;
#pragma unroll 1
    for (int step = 0; step < 8; ++step) {
      if (issuer && step == 4) {
        cross_produce<T>(L, U, full, empty);
      } else if (issuer && step != 1) {
        const int ph = step == 0 ? kQkv : step == 2 ? kOut : step == 3 ? kCrossQ
                     : step == 5 ? kCrossOut : step == 6 ? kFc : kProj;
        product_produce<T>(L, ph, U, wfull, wempty, wuse);
      }
      __syncwarp();  // the issuing lane meets its warp again before the grid barrier
      if (step < 7) grid.sync();
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(DS_COMPUTE_REGS));
    const Layer<T> L(args);
    float* qsm = reinterpret_cast<float*>(smem + DS_UNION);
    float* lg = qsm + DS_DH;
    float* red = lg + DS_MAX_CHUNK;
    float* part = red + 16;
#pragma unroll 1
    for (int step = 0; step < 8; ++step) {
      if (step == 1) {
        self_attention<T>(L, U, qsm, lg, red, part);
      } else if (step == 4) {
        cross_consume<T>(L, U, qsm, lg, red, part, full, empty);
      } else {
        const int ph = step == 0 ? kQkv : step == 2 ? kOut : step == 3 ? kCrossQ
                     : step == 5 ? kCrossOut : step == 6 ? kFc : kProj;
        product_consume<T>(L, ph, U, wfull, wempty, wuse);
      }
      if (step < 7) grid.sync();
    }
  }
}

// The unit shape of a product phase (N columns, K deep; `merge` floats of
// scratch a row): the fewest rounds of units over the grid, then the most
// units (the smallest), then the widest slab, among the shapes whose input
// tile, weight slab and scratch fit the shared region.  -1: none fits.
inline int pick_shape(int B, int N, int K, int grid, int elem, int merge) {
  int best = -1;
  long best_rounds = 0, best_units = 0;
  const int rows = (B + 7) / 8 * 8;
  for (int i = 0; i < kNumShapes; ++i) {
    const int tr = kShapes[i].tr, tn = kShapes[i].tn, ns = DS_WARPS * tn;
    if (tr > rows || N % ns) continue;
    const long bytes = (long)tr * K * 4 + (long)ns * K * elem + (long)tr * merge * 4;
    if (bytes > DS_UNION) continue;
    const long units = (long)((B + tr - 1) / tr) * (N / ns);
    const long rounds = (units + grid - 1) / grid;
    if (best < 0 || rounds < best_rounds ||
        (rounds == best_rounds &&
         (units > best_units || (units == best_units && tn > kShapes[best].tn)))) {
      best = i;
      best_rounds = rounds;
      best_units = units;
    }
  }
  return best;
}

constexpr int kMaxDevices = 64;
static int g_grid[2][kMaxDevices];  // co-resident blocks of the launch, per dtype and device

template <typename T>
int run_layer_step(StepArgs<T> a, int dtype, int device, cudaStream_t s) {
  auto kern = decoder_layer_kernel<T>;
  int& grid = g_grid[dtype][device];
  if (grid == 0) {
    int sms = 0, per_sm = 0;
    QASR_TRY(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, DS_SMEM));
    QASR_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
    QASR_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, DS_BLOCK, DS_SMEM));
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid = sms * per_sm;
  }
  const int D = a.D, elem = (int)sizeof(T);
  const int dims[kProducts][3] = {{3 * D, D, 0},
                                  {D, D, a.H * merge_scratch(a.ss)},
                                  {D, D, 0},
                                  {D, D, a.H * merge_scratch(a.sx)},
                                  {4 * D, D, 0},
                                  {D, 4 * D, 0}};
  for (int ph = 0; ph < kProducts; ++ph) {
    a.shape[ph] = pick_shape(a.B, dims[ph][0], dims[ph][1], grid, elem, dims[ph][2]);
    if (a.shape[ph] < 0) return (int)cudaErrorInvalidValue;
  }
  void* params[] = {&a};
  QASR_TRY(cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(DS_BLOCK), params,
                                       DS_SMEM, s));
  return (int)cudaGetLastError();
}

}  // namespace qasr

using namespace qasr;

// x, out (B, D), packed weights, self K/V (B, H, ctx, 64) and cross K/V
// (B, H, Ta, 64) in the compute dtype, 16-byte aligned; ln (6, D) fp32;
// work fp32 of ops/decoder_step.py `_work_floats`.  B % 8 == 0, D = 64 H in
// {384, 512}, 0 <= idx < ctx; the attention plans (`attention_split`):
// self cs positions a chunk in ss chunks over idx + 1 positions, cross cx
// in sx over Ta, each chunk a multiple of 16 up to 128 positions (a chunk
// past the visible positions is empty).
extern "C" int qasr_decoder_layer_step(int dtype, const void* x, const void* w,
                                       const void* ln, void* self_k, void* self_v,
                                       const void* cross_k, const void* cross_v, void* out,
                                       void* work, int B, int D, int H, int ctx, int Ta,
                                       int idx, int cs, int ss, int cx, int sx, int device,
                                       void* stream) {
  const int cmax = DS_CHUNK_BYTES / (DS_DH * (dtype == kF32 ? 4 : 2));
  const auto bad_plan = [cmax](int c, int s, int t) {
    return c < 16 || c > cmax || c % 16 || s < 1 || (long long)c * s < t;
  };
  if (B < 8 || B % 8 || D != 64 * H || D % 128 || D > DS_MAX_D || idx < 0 || idx >= ctx ||
      Ta < 1 || bad_plan(cs, ss, idx + 1) || bad_plan(cx, sx, Ta) || device < 0 ||
      device >= kMaxDevices || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return run_layer_step<float>(
        {(const float*)x, (const float*)w, (const float*)ln, (float*)self_k, (float*)self_v,
         (const float*)cross_k, (const float*)cross_v, (float*)out, (float*)work, B, D, H,
         ctx, Ta, idx, cs, ss, cx, sx},
        dtype, device, s);
  using bf = __nv_bfloat16;
  return run_layer_step<bf>({(const bf*)x, (const bf*)w, (const float*)ln, (bf*)self_k,
                             (bf*)self_v, (const bf*)cross_k, (const bf*)cross_v, (bf*)out,
                             (float*)work, B, D, H, ctx, Ta, idx, cs, ss, cx, sx},
                            dtype, device, s);
}
