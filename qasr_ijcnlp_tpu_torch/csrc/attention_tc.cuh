// Tensor-core attention core of K4 (qasr_attention, encoder_block.cu), K7
// (qasr_flash_attention) and K8 (qasr_packed_attention, both flash.cu), and
// of K11's `dots` and `full` modes (qasr_attn_parts, attn_parts.cu).
//
// out[b, h, t, :dh] = softmax_j(q_t . k_j, keys j < t_real) v_j for one head
// h of any width dh <= 256, q and k pre-scaled by the caller, each operand
// addressed through its own (batch, head, row) element strides with unit
// column stride, Tq and Tk free.  The logits and the softmax are fp32; p is
// rounded to the compute dtype only for the PV product, while the
// denominator sums the unrounded fp32 p (the rule of the TPU kernels
// `_attn_kernel` and `_packed_kernel` in qasr_ijcnlp_tpu/ops/flash.py) or,
// with kRoundedSum, the rounded p that PV multiplies (K4's rule: the TPU
// kernel qasr_ijcnlp_tpu/ops/encoder_block.py `_attn_kernel` appends a ones
// block to V, so its denominator sums the p it multiplies; in f32 the two
// rules are one).
//
// Bound on the H100: operations, 4 * B * H * min(Tq, t_real) * t_real * dh
// FLOP on the tensor cores (989 TFLOP/s in bf16; in f32 three TF32 products
// per product, 495 / 3 TFLOP/s); the bytes (each operand read once) are
// 5-10x below that line at Whisper's shapes.
//
// Design (sm_90a):
// * Blocks.  One block owns QR = 64 * NWG query rows of one head of one
//   batch item: NWG consumer warpgroups of 64 rows each, plus one producer
//   warp.  The block walks the keys in tiles of KT rows through a ring of
//   STAGES shared-memory stages; key tiles at or past t_real are never
//   loaded.  TcCfg picks (NWG, KT, STAGES) per dtype and padded head
//   width W so that shared memory fits 227 KB.
// * Copies.  Lane 0 of the producer warp loads Q once and each K/V tile
//   with TMA (cp.async.bulk.tensor, 5D maps over (8 or 4 columns, row,
//   column chunk, head, batch)) onto mbarriers, so tile j+1 lands while
//   tile j is in the products.  The maps' row extent is t_real for K and V
//   (Tq for Q) and their column extent dh, so TMA writes zeros for keys >=
//   t_real, padded query rows and columns dh..W-1: padding rows may hold
//   inf/NaN, and 0 * NaN would poison PV.  The box lands in the core-matrix
//   layout that wgmma reads without swizzle: 16-byte column chunks, each a
//   run of rows 16 bytes apart (cm_idx).  Operands that TMA cannot address
//   (base not 16-byte aligned, a row, head or batch stride not a multiple
//   of 16 bytes, or dh not a multiple of the chunk) are loaded by the same
//   producer warp with plain loads into the same layout, with the same
//   zeros; the rest of the kernel is the same.
// * bf16.  S = Q K^T is wgmma m64nKTk16 with Q and K both K-major in shared
//   memory, straight from the TMA buffers.  The online softmax runs in fp32
//   registers in the accumulator layout (row max by quad shuffles, the
//   per-thread sum reduced once at the end, O rescaled by alpha per tile).
//   O += P V takes P from registers (rounded to bf16) as the A operand and
//   V straight from the ring as an MN-major B operand (transpose bit set):
//   its TMA layout, 8 dh columns of 8 keys in each 128-byte core matrix, is
//   the MN-major no-swizzle layout, so V is never copied in shared memory.
//   A stage goes back to the producer when both products have read it.
// * f32 by 3xTF32.  Every fp32 operand x is split into hi = tf32(x) and
//   lo = tf32(x - hi) (cvt.rna.tf32.f32), and each product accumulates
//   hi.lo' + lo.hi' + hi.hi' in fp32 on wgmma .tf32, for both products.
//   Single TF32 keeps ~3 digits, too few for the 1e-4 the port holds f32
//   kernels to.  wgmma's .tf32 form takes K-major operands only, so the
//   consumers split Q once (hi in place, lo beside it), and per tile split
//   K in place and write V transposed into Vt hi/lo: the split needs a pass
//   over the tile anyway, and the transpose rides on it (the alternative,
//   mma.sync m16n8k8 with fragments loaded by hand, would feed the tensor
//   cores at a lower rate).  The pass is SIMT work that does not overlap
//   the block's own products; other blocks on the SM fill that gap.  The
//   PV A operand comes from the S accumulator, whose thread holds keys 2q,
//   2q + 1 of each 8-key group where the tf32
//   A fragment wants k = q, q + 4; Vt stores each group's keys in that
//   order (even keys, then odd), so no shuffle is needed.
// * Head widths.  Compiled at W = 16, 32, 64, 96, 128 and 256 and launched
//   at the smallest W >= dh; PV runs in slices of at most 64 columns.
// * Modes (kMode, bf16 only beside the attention; K11's diagnostic split).
//   kTcAttention is the above and compiles to the code it had before the
//   modes.  K11's two modes take operands TMA can address only.  kTcDots
//   skips the softmax: p = bf16(S), no max, no rescale of O, no division.
//   kTcFull normalises p before rounding it, as the TPU script does: the
//   block walks the key tiles twice, first K alone (the producer loads no
//   V, a stage's transaction count is K's bytes) for each row's max and
//   fp32 denominator of the unrounded p, then K and V with p = bf16(exp(s
//   - m) / l) into PV and no rescale.  The ring's stages and mbarrier
//   phases run on through both passes (item n_tiles + j of pass 2 is tile
//   j).
#pragma once

#include "hopper.cuh"

namespace qasr {

constexpr int kTcMaxHeadWidth = 256;

// What a launch of the core computes (see Modes above).
enum TcMode : int { kTcAttention = 0, kTcDots = 1, kTcFull = 2 };

// Per-operand (batch, head, row) element strides, unit column stride.
struct TcOperand {
  const void* p;
  long long b, h, t;
};

struct TcArgs {
  TcOperand q, k, v;
  void* out;
  long long ob, oh, ot;  // out's (batch, head, row) element strides
  int Tq, t_real, dh, tma;
};

// (consumer warpgroups, key-tile rows, ring stages) per dtype and width.
template <typename T, int W>
struct TcCfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int NWG = kF32 ? (W <= 128 ? 2 : 1) : 2;
  static constexpr int KT = kF32 ? (W <= 64 ? 64 : (W <= 96 ? 32 : 16)) : 64;
  static constexpr int STAGES = kF32 && W > 128 ? 1 : 2;
  static constexpr int E = sizeof(T);
  static constexpr int CH = 16 / E;  // elements of one 16-byte column chunk
  static constexpr int QR = 64 * NWG;
  static constexpr int THREADS = 128 * NWG + 32;
  // Shared memory, bytes: Q (f32: hi in place, lo beside it), the ring of
  // K and V tiles, and f32's K lo and Vt (hi and lo).
  static constexpr int kQ = QR * W * E;
  static constexpr int kQl = kF32 ? QR * W * 4 : 0;
  static constexpr int kStage = 2 * KT * W * E;
  static constexpr int kKl = kF32 ? KT * W * 4 : 0;
  static constexpr int kVt = kF32 ? 2 * KT * W * 4 : 0;
  static constexpr int kBar = kQ + kQl + STAGES * kStage + kKl + kVt;
  static constexpr int kSmem = kBar + (2 * STAGES + 1) * 8;
  static_assert(kSmem <= 232448, "shared memory over 227 KB");
};

// Element index of (row r, column c) in a tile of R rows laid out as 16-byte
// column chunks, each a run of R rows (wgmma's no-swizzle K-major layout).
template <int CH>
__device__ __forceinline__ int cm_idx(int r, int c, int R) {
  return (c / CH) * R * CH + r * CH + (c % CH);
}

// ------------------------------------------------------------- kernel ------

// O[:, N0:W] += A V for one k-step, in slices of at most 64 columns; V is
// f32's K-major Vt (dh rows of keys) or bf16's MN-major ring tile (key rows
// of dh, read with the transpose bit).
template <typename T, int W, int KT, int N0 = 0>
__device__ __forceinline__ void pv_slices(float* o, const uint32_t* a, const T* v) {
  if constexpr (N0 < W) {
    constexpr int NS = W - N0 >= 64 ? 64 : W - N0;
    if constexpr (std::is_same<T, float>::value)
      Wgmma<NS>::rs(o + N0 / 2, a, gmma_desc(v + N0 * 4, W * 16), T());
    else  // N0 / 8 chunks of KT key rows; 8 keys (128 bytes) per core matrix
      Wgmma<NS>::rs(o + N0 / 2, a, gmma_desc(v + N0 * KT, 128, KT * 16), T());
    pv_slices<T, W, KT, N0 + NS>(o, a, v);
  }
}

// The producer warp's plain loads (operands TMA cannot address): rows
// row0..row0+R-1 of one head into the chunked layout, zeros at rows >=
// `rows` and columns >= dh.
template <typename T, int W>
__device__ void plain_tile(T* dst, const TcOperand& x, int b, int h, int row0, int R,
                           int rows, int dh, int lane) {
  const T* src = static_cast<const T*>(x.p) + b * x.b + h * x.h;
  for (int i = lane; i < R * W; i += 32) {
    const int r = i / W, c = i % W, t = row0 + r;
    dst[cm_idx<16 / sizeof(T)>(r, c, R)] =
        (t < rows && c < dh) ? src[(long long)t * x.t + c] : from_f<T>(0.f);
  }
  fence_proxy_async();
  __syncwarp();
}

template <typename T, int W, bool kRoundedSum, int kMode = kTcAttention>
__global__ void __launch_bounds__(TcCfg<T, W>::THREADS, 1)
attn_tc_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, const TcArgs a) {
  using C = TcCfg<T, W>;
  constexpr bool F32 = C::kF32;
  static_assert(kMode == kTcAttention || !F32, "K11's modes are bf16 only");
  constexpr int NWG = C::NWG, KT = C::KT, ST = C::STAGES, CH = C::CH, QR = C::QR;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);                          // [QR x W], f32: hi
  float* Ql = reinterpret_cast<float*>(smem + C::kQ);          // f32: lo
  unsigned char* ring = smem + C::kQ + C::kQl;                 // ST x (K, V) tiles
  float* Kl = reinterpret_cast<float*>(ring + ST * C::kStage);  // f32: K lo
  float* Vt = reinterpret_cast<float*>(ring + ST * C::kStage + C::kKl);  // f32: hi, lo
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + ST;
  uint64_t* qbar = empty + ST;
  auto Ks = [&](int s) { return reinterpret_cast<T*>(ring + s * C::kStage); };
  auto Vs = [&](int s) { return Ks(s) + KT * W; };

  const int tid = threadIdx.x, h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * QR;
  const int n_tiles = (a.t_real + KT - 1) / KT;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * NWG) {  // ---- producer warp ----
    const int lane = tid & 31;
    if constexpr (kMode == kTcFull) {  // pass 1: K tiles alone; pass 2: K and V (TMA only)
      if (lane == 0) {
        mbar_expect_tx(qbar, C::kQ);
        tma_load5(Qs, &mq, qbar, 0, q0, 0, h, b);
        for (int j = 0; j < 2 * n_tiles; ++j) {
          const int s = j % ST, t = j < n_tiles ? j : j - n_tiles;
          const bool v_too = j >= n_tiles;
          if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
          mbar_expect_tx(&full[s], v_too ? C::kStage : C::kStage / 2);
          tma_load5(Ks(s), &mk, &full[s], 0, t * KT, 0, h, b);
          if (v_too) tma_load5(Vs(s), &mv, &full[s], 0, t * KT, 0, h, b);
        }
      }
      return;
    }
    if (a.tma) {
      if (lane == 0) {
        mbar_expect_tx(qbar, C::kQ);
        tma_load5(Qs, &mq, qbar, 0, q0, 0, h, b);
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % ST;
          if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
          mbar_expect_tx(&full[s], C::kStage);
          tma_load5(Ks(s), &mk, &full[s], 0, j * KT, 0, h, b);
          tma_load5(Vs(s), &mv, &full[s], 0, j * KT, 0, h, b);
        }
      }
    } else {
      plain_tile<T, W>(Qs, a.q, b, h, q0, QR, a.Tq, a.dh, lane);
      if (lane == 0) mbar_arrive(qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], (j / ST - 1) & 1);
        plain_tile<T, W>(Ks(s), a.k, b, h, j * KT, KT, a.t_real, a.dh, lane);
        plain_tile<T, W>(Vs(s), a.v, b, h, j * KT, KT, a.t_real, a.dh, lane);
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  constexpr int NC = 128 * NWG;
  const int wg = tid / 128, wtid = tid % 128, warp = wtid / 32, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  mbar_wait(qbar, 0);
  if constexpr (F32) {  // split this warpgroup's Q rows: hi in place, lo beside
    for (int i = wtid; i < 64 * W; i += 128) {
      const int idx = cm_idx<CH>(64 * wg + i / W, i % W, QR);
      const float x = Qs[idx], hi = tf32_rna(x);
      Qs[idx] = hi;
      Ql[idx] = tf32_rna(x - hi);
    }
    fence_proxy_async();
    named_bar(2 + wg, 128);
  }
  const T* Qw = Qs + 64 * wg * CH;
  const float* Qlw = Ql + 64 * wg * CH;

  float o[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};

  float inv_l[2] = {1.f, 1.f};  // kTcFull: 1 / each row's denominator
  if constexpr (kMode == kTcFull) {  // pass 1: each row's max and fp32 denominator
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST, k0 = j * KT;
      mbar_wait(&full[s], (j / ST) & 1);
      const T* Kt = Ks(s);
      float sacc[KT / 2];
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) sacc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W / (2 * CH); ++kk)
        Wgmma<KT>::ss(sacc, gmma_desc(Qw + 2 * kk * QR * CH, QR * 16),
                      gmma_desc(Kt + 2 * kk * KT * CH, KT * 16), T());
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<KT / 2>(sacc);
      named_bar(2 + wg, 128);
      if (wtid == 0) mbar_arrive(&empty[s]);  // K alone: the stage is spent
      if (k0 + KT > a.t_real) {
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)
          if (k0 + 8 * (i / 4) + 2 * qd + (i & 1) >= a.t_real) sacc[i] = -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
          mt = fmaxf(mt, fmaxf(sacc[4 * i + 2 * r], sacc[4 * i + 2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m_run[r], mt);
        float ls = 0.f;
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
          ls += expf(sacc[4 * i + 2 * r] - m_new) + expf(sacc[4 * i + 2 * r + 1] - m_new);
        l_part[r] = l_part[r] * expf(m_run[r] - m_new) + ls;
        m_run[r] = m_new;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_part[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv_l[r] = 1.f / l;
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    // the ring item: pass 2 of kTcFull follows its n_tiles items of pass 1
    const int it = (kMode == kTcFull ? n_tiles : 0) + j;
    const int s = it % ST, k0 = j * KT;
    mbar_wait(&full[s], (it / ST) & 1);
    T* Kt = Ks(s);
    const T* Vtile = Vs(s);
    if constexpr (F32) {
      named_bar(1, NC);  // every warpgroup is done with the last tile's Vt, Kl
      for (int i = tid; i < KT * W; i += NC) {  // i walks the chunked tile layout
        const int r = (i % (KT * CH)) / CH, c = (i / (KT * CH)) * CH + i % CH;
        const float v = Vtile[i];
        // key r sits at position 8 (r / 8) + (r even ? r % 8 / 2 : 4 + r % 8 / 2)
        const int p = (r & ~7) + ((r & 1) ? 4 : 0) + ((r & 7) >> 1);
        const int t = cm_idx<CH>(c, p, W);
        const float vh = tf32_rna(v);
        Vt[t] = vh;
        Vt[KT * W + t] = tf32_rna(v - vh);
        const float x = Kt[i], kh = tf32_rna(x);
        Kt[i] = kh;
        Kl[i] = tf32_rna(x - kh);
      }
      fence_proxy_async();
      named_bar(1, NC);
    }

    // S = Q K^T (f32: Qhi Klo + Qlo Khi + Qhi Khi)
    float sacc[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) sacc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W / (2 * CH); ++kk) {
      const int qo = 2 * kk * QR * CH, ko = 2 * kk * KT * CH;
      const uint64_t dq = gmma_desc(Qw + qo, QR * 16), dk = gmma_desc(Kt + ko, KT * 16);
      if constexpr (F32) {
        Wgmma<KT>::ss(sacc, dq, gmma_desc(Kl + ko, KT * 16), T());
        Wgmma<KT>::ss(sacc, gmma_desc(Qlw + qo, QR * 16), dk, T());
      }
      Wgmma<KT>::ss(sacc, dq, dk, T());
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<KT / 2>(sacc);
    if constexpr (F32) {  // the ring stage is spent: V lives on in Vt
      named_bar(2 + wg, 128);
      if (wtid == 0) mbar_arrive(&empty[s]);
    }

    // online softmax on rows g (r = 0) and g + 8 (r = 1) of this warp's 16
    if (k0 + KT > a.t_real) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i)
        if (k0 + 8 * (i / 4) + 2 * qd + (i & 1) >= a.t_real)
          sacc[i] = kMode == kTcDots ? 0.f : -INFINITY;
    }
    if constexpr (kMode == kTcFull) {  // p normalised before PV rounds it
#pragma unroll
      for (int i = 0; i < KT / 2; ++i)
        sacc[i] = expf(sacc[i] - m_run[(i >> 1) & 1]) * inv_l[(i >> 1) & 1];
    }
    if constexpr (kMode == kTcAttention) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
          mt = fmaxf(mt, fmaxf(sacc[4 * i + 2 * r], sacc[4 * i + 2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        // tile 0 holds key 0 < t_real, so m_new is finite from the start
        const float m_new = fmaxf(m_run[r], mt), alpha = expf(m_run[r] - m_new);
        float ls = 0.f;
#pragma unroll
        for (int i = 0; i < KT / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = expf(sacc[4 * i + 2 * r + e] - m_new);
            sacc[4 * i + 2 * r + e] = p;
            ls += kRoundedSum ? rnd<T>(p) : p;  // K4: the p PV multiplies
          }
        l_part[r] = l_part[r] * alpha + ls;
        m_run[r] = m_new;
#pragma unroll
        for (int i = 0; i < W / 8; ++i) {
          o[4 * i + 2 * r] *= alpha;
          o[4 * i + 2 * r + 1] *= alpha;
        }
      }
    }

    // O += P V, P rounded to T as the register A operand
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < KT / (2 * CH); ++t) {
      if constexpr (F32) {
        const float* vt = Vt + 2 * t * W * CH;
        const float* p = sacc + 4 * t;
        const float pa[4] = {p[0], p[2], p[1], p[3]};  // k = q, q (row + 8), q + 4, ...
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ph = tf32_rna(pa[e]);
          hi[e] = __float_as_uint(ph);
          lo[e] = __float_as_uint(tf32_rna(pa[e] - ph));
        }
        pv_slices<T, W, KT>(o, lo, vt);
        pv_slices<T, W, KT>(o, hi, vt + KT * W);
        pv_slices<T, W, KT>(o, hi, vt);
      } else {
        const float* p = sacc + 8 * t;
        const uint32_t pa[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]),
                                pack_bf16(p[4], p[5]), pack_bf16(p[6], p[7])};
        pv_slices<T, W, KT>(o, pa, Vtile + 16 * t * CH);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<W / 2>(o);
    if constexpr (!F32) {  // the ring stage is spent after PV
      named_bar(2 + wg, 128);
      if (wtid == 0) mbar_arrive(&empty[s]);
    }
  }

  T* ob = static_cast<T*>(a.out) + b * a.ob + h * a.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    if constexpr (kMode == kTcAttention) {
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
    }
    const int t = q0 + 64 * wg + 16 * warp + g + 8 * r;
    if (t >= a.Tq) continue;
    T* orow = ob + (long long)t * a.ot;
#pragma unroll
    for (int i = 0; i < W / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * qd + e;
        if (col < a.dh)
          orow[col] = from_f<T>(kMode == kTcAttention ? o[4 * i + 2 * r + e] / l
                                                      : o[4 * i + 2 * r + e]);
      }
  }
}

// ---------------------------------------------------------------- host -----

// Whether TMA can address operand x: a 16-byte-aligned base, row, head and
// batch strides of whole 16-byte units (where that dimension has more than
// one entry), and dh a whole number of chunks.
inline bool tma_ok(const TcOperand& x, int e, int dh, int H, int B) {
  const long long u = 16 / e;
  return reinterpret_cast<uintptr_t>(x.p) % 16 == 0 && dh % u == 0 && x.t % u == 0 &&
         (H == 1 || x.h % u == 0) && (B == 1 || x.b % u == 0);
}

// 5D map over (chunk columns, row, chunk, head, batch) of one operand, rows
// < `rows` and columns < dh in bounds (the rest reads as zeros), box of R
// rows and the padded width W.
inline cudaError_t encode_operand(CUtensorMap* map, const TcOperand& x, bool f32, int rows,
                                  int dh, int H, int B, int R, int W) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = f32 ? 4 : 2, ch = 16 / e;
  const auto stride = [&](long long s, int n) { return n == 1 ? 16 : (cuuint64_t)s * e; };
  const cuuint64_t dims[5] = {ch, (cuuint64_t)rows, (cuuint64_t)dh / ch, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)x.t * e, 16, stride(x.h, H), stride(x.b, B)};
  const cuuint32_t box[5] = {(cuuint32_t)ch, (cuuint32_t)R, (cuuint32_t)(W / ch), 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        5, const_cast<void*>(x.p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int W, bool kRoundedSum = false, int kMode = kTcAttention>
inline cudaError_t launch_attn_tc_width(TcArgs a, int B, int H, cudaStream_t s) {
  using C = TcCfg<T, W>;
  constexpr bool f32 = C::kF32;
  CUtensorMap mq{}, mk{}, mv{};
  a.tma = tma_ok(a.q, C::E, a.dh, H, B) && tma_ok(a.k, C::E, a.dh, H, B) &&
          tma_ok(a.v, C::E, a.dh, H, B);
  if (kMode != kTcAttention && !a.tma) return cudaErrorInvalidValue;  // K11: TMA only
  if (a.tma) {
    cudaError_t e = encode_operand(&mq, a.q, f32, a.Tq, a.dh, H, B, C::QR, W);
    if (e == cudaSuccess) e = encode_operand(&mk, a.k, f32, a.t_real, a.dh, H, B, C::KT, W);
    if (e == cudaSuccess) e = encode_operand(&mv, a.v, f32, a.t_real, a.dh, H, B, C::KT, W);
    if (e != cudaSuccess) return e;
  }
  const cudaError_t e = cudaFuncSetAttribute(
      attn_tc_kernel<T, W, kRoundedSum, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Tq + C::QR - 1) / C::QR, H, B);
  attn_tc_kernel<T, W, kRoundedSum, kMode><<<grid, C::THREADS, C::kSmem, s>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

// Launch at the smallest compiled width that holds a.dh; a wider head (the
// wrappers refuse it first) is cudaErrorInvalidValue.
template <typename T>
inline cudaError_t launch_attn_tc(const TcArgs& a, int B, int H, cudaStream_t s) {
  if (a.dh < 1 || a.t_real < 1) return cudaErrorInvalidValue;
  if (a.dh <= 16) return launch_attn_tc_width<T, 16>(a, B, H, s);
  if (a.dh <= 32) return launch_attn_tc_width<T, 32>(a, B, H, s);
  if (a.dh <= 64) return launch_attn_tc_width<T, 64>(a, B, H, s);
  if (a.dh <= 96) return launch_attn_tc_width<T, 96>(a, B, H, s);
  if (a.dh <= 128) return launch_attn_tc_width<T, 128>(a, B, H, s);
  if (a.dh <= kTcMaxHeadWidth) return launch_attn_tc_width<T, 256>(a, B, H, s);
  return cudaErrorInvalidValue;
}

}  // namespace qasr
