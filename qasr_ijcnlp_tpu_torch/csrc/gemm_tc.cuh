// Tensor-core GEMM of the fused encoder block (K4's Q/K/V projection and
// K5/K6's out-projection, fc and proj; encoder_block.cu), the conv stem
// (K2/K3's two convolutions; conv_stem.cu) and the mel frontend (K1's DFT
// and mel products; melfront.cu).
//
// C[m, n] = ep(m, n, sum_k A[m, k] W[n, k]): A a row-major (M, K)
// activation, W a weight in the nn.Linear (N, K) layout, both K-major, as
// wgmma wants them (and the only layout it takes for .tf32), so nothing is
// transposed.  The epilogue functor gets each thread's accumulator pairs
// (row m, columns n and n + 1) in fp32 and applies the caller's bias,
// rounding, activation and residual in registers.
//
// Tap views.  A may also be `taps` shifted row views of one row-major
// buffer X (rows, k_tap): A[m, j k_tap + c] = X[stride m + j, c], so a
// convolution of width `taps` and stride `stride` over X's rows is one
// GEMM against its weight in tap-major (N, taps k_tap) layout, with no
// im2col copy.  k-slice kb belongs to tap j = kb / (k_tap / BK); the
// producer reads it through a 4D map of X as (k_tap, stride, rows /
// stride, slabs), at (c0, j % stride, m0 + j / stride, slab): row stride
// (m0 + i) + j of X is phase j % stride of row pair m0 + i + j / stride.
// No two dimensions of the map overlap.  Rows past X's end read as zeros
// (TMA's fill).  The plain (M, K) operand is the one-tap case, read
// through its own 3D map by the code it had before tap views existed.
//
// Bound on the H100: operations, 2 M N K FLOP on the tensor cores (989
// TFLOP/s in bf16; 495 / 3 in f32, three TF32 products per product); the
// encoder block's shapes are far above the bytes line.
//
// Design (sm_90a):
// * Tiles.  One block computes a 128 x 128 tile of C: two consumer
//   warpgroups of 64 rows each and one producer warp.  A 3-stage ring (96
//   KB in bf16) lets two blocks share an SM, so one block's epilogue and
//   ring fill overlap the other's products; in f32 (192 KB) one fits.
//   Timed on the H100 against a 4-stage bf16 ring, 256-column bf16 tiles
//   (m64n256k16) and a persistent grid walking the tiles, none was faster
//   over medium's four products.  N and K are multiples of 128 on every
//   shape the fused-block gate admits (D a multiple of 128, N in {D, 3D,
//   4D}, K in {D, 4D}), so no tile has a ragged column edge, and a QKV tile
//   never straddles two of the q, k, v segments; rows past M are
//   zero-filled by TMA and never stored.
// * Copies.  Lane 0 of the producer warp streams 128-byte-wide k-slices of
//   A and W (64 bf16 or 32 f32 columns, 128 rows each) with TMA onto a ring
//   of STAGES mbarrier stages, in the 128-byte swizzle
//   (CU_TENSOR_MAP_SWIZZLE_128B) that wgmma's K-major descriptor reads
//   without bank conflicts; a k-step inside the slice advances the
//   descriptor's start address by 32 bytes.
// * Products.  Each consumer warpgroup runs wgmma m64n128k16 (bf16) or
//   m64n128k8 (.tf32) over the stage.  bf16 keeps one commit group in
//   flight: the stage of group j - 1 goes back to the producer once group j
//   is issued and j - 1 has completed.  The accumulators (64 fp32 a
//   thread) stay in registers until the epilogue.
// * f32 by 3xTF32.  Single TF32 keeps ~3 digits, too few for the 1e-4 the
//   port holds f32 kernels to, so each operand comes as two slabs, hi =
//   tf32(x) and lo = tf32(x - hi) (cvt.rna.tf32.f32), and each k-step
//   accumulates hi.lo' + lo.hi' + hi.hi' in fp32.  The tensor cores' fp32
//   accumulation drops low bits at each step, an error that grows with K,
//   so each slice's products go into a fresh accumulator that the CUDA
//   cores add to the running one (the slice waits for its products).  The
//   GEMM does no split of its own (a SIMT pass in the block would not
//   overlap its products): the weights are split once per model
//   (ops/encoder_block.py), and each f32 activation by the kernel that
//   writes it (the LayerNorm, the fc epilogue, one elementwise pass over
//   the attention output).  A stage then holds four tiles (A hi, A lo, W
//   hi, W lo: 64 KB); bf16 holds two tiles (32 KB).
#pragma once

#include "hopper.cuh"

namespace qasr {

template <typename T>
struct GemmCfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int BM = 128, BN = 128;  // C tile; two 64-row warpgroups
  static constexpr int BK = 128 / (int)sizeof(T);  // one 128-byte swizzle row
  static constexpr int KSTEPS = 4;  // wgmma k-steps of 32 bytes in a slice
  static constexpr int SLABS = kF32 ? 2 : 1;  // hi (and lo) of each operand
  static constexpr int STAGES = 3;
  static constexpr int kTile = BM * 128;  // bytes of one A or W slice (BM == BN)
  static constexpr int kSlab = 2 * kTile;  // one slab's A and W slices
  static constexpr int kStage = SLABS * kSlab;
  static constexpr int kBar = STAGES * kStage;
  // 1024 bytes of slack to align the ring to the swizzle atom
  static constexpr int kSmem = 1024 + kBar + 2 * STAGES * 8;
  static constexpr int THREADS = 2 * 128 + 32;
  static_assert(BM == BN, "A and W slices share one size");
  static_assert(kSmem <= 232448, "shared memory over 227 KB");
};

// The bf16 pair or fp32 pair at p (n even, so 4- or 8-byte aligned).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The value v stored at index i of an A operand: bf16 as is; f32 as hi at
// y[i] and lo at y[i + slab] for the 3xTF32 products.
__device__ __forceinline__ void store_operand(__nv_bfloat16* y, size_t i, size_t, float v) {
  y[i] = __float2bfloat16(v);
}
__device__ __forceinline__ void store_operand(float* y, size_t i, size_t slab, float v) {
  const float hi = tf32_rna(v);
  y[i] = hi;
  y[i + slab] = tf32_rna(v - hi);
}
// The pair (a, b) at i, i + 1 (i even) as one store a slab: half the
// store instructions of two store_operand calls (the stem's conv1 epilogue
// took 13-20% less time on the H100; PERF.md).
__device__ __forceinline__ void store_operand2(__nv_bfloat16* y, size_t i, size_t, float a,
                                               float b) {
  store2(y + i, a, b);
}
__device__ __forceinline__ void store_operand2(float* y, size_t i, size_t slab, float a,
                                               float b) {
  const float ha = tf32_rna(a), hb = tf32_rna(b);
  store2(y + i, ha, hb);
  store2(y + i + slab, tf32_rna(a - ha), tf32_rna(b - hb));
}

// kTaps: ma is A as the 4D tap view above, kt k-slices a tap, `stride`
// the views' row stride; else ma is the plain (K, M, slab) 3D map (kt and
// stride unused), the code of the one-tap callers (K4, K5/K6) unchanged:
// the tap view's producer arithmetic and 4D boxes cost them 2-7% on the
// H100 (PERF.md).
template <typename T, class EP, bool kTaps>
__global__ void __launch_bounds__(GemmCfg<T>::THREADS, 1)
gemm_tc_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mw,
               int M, int K, int kt, int stride, const EP ep) {
  using C = GemmCfg<T>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBar);
  uint64_t* empty = full + ST;
  // slab o (0 hi, 1 lo) of stage s: the A slice, then the W slice
  auto slice_a = [&](int s, int o) { return smem + s * C::kStage + o * C::kSlab; };
  auto slice_w = [&](int s, int o) { return slice_a(s, o) + C::kTile; };

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int nk = K / C::BK;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // ---- producer warp ----
    if (tid == 256) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % ST;
        if (kb >= ST) mbar_wait(&empty[s], (kb / ST - 1) & 1);
        mbar_expect_tx(&full[s], C::kStage);
        for (int o = 0; o < C::SLABS; ++o) {
          if constexpr (kTaps) {
            const int j = kb / kt;  // the slice's tap
            tma_load4(slice_a(s, o), &ma, &full[s], (kb - j * kt) * C::BK, j % stride,
                      m0 + j / stride, o);
          } else {
            tma_load3(slice_a(s, o), &ma, &full[s], kb * C::BK, m0, o);
          }
          tma_load3(slice_w(s, o), &mw, &full[s], kb * C::BK, n0, o);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows 64 wg .. 64 wg + 63 of the tile ----
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % ST;
    mbar_wait(&full[s], (kb / ST) & 1);
    const unsigned char* a = slice_a(s, 0) + wg * 64 * 128;
    const unsigned char* w = slice_w(s, 0);
    if constexpr (C::kF32) {
      // The slice's 12 products go into a fresh accumulator, which is then
      // added to acc on the CUDA cores (round to nearest): the tensor
      // cores' own fp32 accumulation drops low bits at each step, an error
      // that would otherwise grow with K (1.6e-4 at K = 4096 on N(0, 1)
      // rows, over the 1e-4 f32 tolerance).
      float part[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) part[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk) {  // the lo slabs sit kSlab past the hi
        const uint64_t ah = gmma_desc_sw128(a + 32 * kk), wh = gmma_desc_sw128(w + 32 * kk);
        Wgmma<128>::ss(part, ah, gmma_desc_sw128(w + C::kSlab + 32 * kk), T());
        Wgmma<128>::ss(part, gmma_desc_sw128(a + C::kSlab + 32 * kk), wh, T());
        Wgmma<128>::ss(part, ah, wh, T());
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<64>(part);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    } else {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk)
        Wgmma<128>::ss(acc, gmma_desc_sw128(a + 32 * kk), gmma_desc_sw128(w + 32 * kk), T());
      wgmma_commit();
      wgmma_wait<1>();  // slice kb - 1 is done: its stage goes back
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(kb - 1) % ST]);
    }
  }
  wgmma_wait<0>();
  fence_regs<64>(acc);

  // accumulator layout: rows g and g + 8 of the warp's 16, columns 8 j +
  // 2 (lane % 4) + {0, 1}
  const int r = m0 + 64 * wg + 16 * warp + lane / 4;
  const int c = n0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (r < M) ep(r, c + 8 * j, acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < M) ep(r + 8, c + 8 * j, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Map of a row-major operand of `slabs` (rows, cols) slabs, box of one
// 128-byte k-slice of 128 rows in the 128-byte swizzle; rows past `rows`
// read as zeros.  W: 3D (cols, rows, slab); A: 4D (cols, stride, rows /
// stride, slab), the tap view (rows a multiple of stride).
template <typename T>
inline cudaError_t encode_gemm_operand(CUtensorMap* map, const T* p, int rows, int cols,
                                       int slabs, int stride = 0) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  constexpr bool f32 = std::is_same<T, float>::value;
  const cuuint64_t e = sizeof(T), row = cols * e, slab = (cuuint64_t)rows * row;
  const cuuint32_t bk = GemmCfg<T>::BK, bm = GemmCfg<T>::BM;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const auto type = f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUresult r;
  if (stride == 0) {
    const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)slabs};
    const cuuint64_t strides[2] = {row, slab};
    const cuuint32_t box[3] = {bk, bm, 1};
    r = fn(map, type, 3, const_cast<T*>(p), dims, strides, box, unit,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)stride,
                                (cuuint64_t)(rows / stride), (cuuint64_t)slabs};
    const cuuint64_t strides[3] = {row, stride * row, slab};
    const cuuint32_t box[4] = {bk, 1, bm, 1};
    r = fn(map, type, 4, const_cast<T*>(p), dims, strides, box, unit,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, bool kTaps, class EP>
inline cudaError_t launch_gemm_kernel(const CUtensorMap& ma, const T* w, int M, int N, int K,
                                      int kt, int stride, const EP& ep, cudaStream_t s) {
  using C = GemmCfg<T>;
  CUtensorMap mw{};
  cudaError_t e = encode_gemm_operand<T>(&mw, w, N, K, C::SLABS);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_tc_kernel<T, EP, kTaps>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(N / C::BN, (M + C::BM - 1) / C::BM);
  gemm_tc_kernel<T, EP, kTaps><<<grid, C::THREADS, C::kSmem, s>>>(ma, mw, M, K, kt, stride, ep);
  return cudaGetLastError();
}

// C = ep(A W^T) with A the tap view of x (x_rows, k_tap) (f32: hi, then lo
// at x + x_rows k_tap): taps views, row m of view j being x's row stride m
// + j; w (N, taps k_tap) tap-major (f32: hi, then lo at w + N K).  N a
// multiple of 128, k_tap of the k-slice (32 f32 or 64 bf16 columns),
// x_rows of stride, both bases 16-byte aligned; anything else is
// cudaErrorInvalidValue.
template <typename T, class EP>
inline cudaError_t launch_wgmma_gemm_taps(const T* x, int x_rows, int k_tap, int taps,
                                          int stride, const T* w, int M, int N, const EP& ep,
                                          cudaStream_t s) {
  using C = GemmCfg<T>;
  if (M < 1 || N % C::BN || k_tap % C::BK || k_tap < C::BK || taps < 1 || stride < 1 ||
      x_rows < stride || x_rows % stride || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap ma{};
  const cudaError_t e = encode_gemm_operand<T>(&ma, x, x_rows, k_tap, C::SLABS, stride);
  if (e != cudaSuccess) return e;
  return launch_gemm_kernel<T, true>(ma, w, M, N, taps * k_tap, k_tap / C::BK, stride, ep, s);
}

// C = ep(A W^T): a holds (M, K) (f32: hi, then lo at a + M K), w (N, K)
// (f32: hi, then lo at w + N K).  N and K must be multiples of 128 and both
// bases 16-byte aligned; anything else is cudaErrorInvalidValue.
template <typename T, class EP>
inline cudaError_t launch_wgmma_gemm(const T* a, const T* w, int M, int N, int K,
                                     const EP& ep, cudaStream_t s) {
  using C = GemmCfg<T>;
  if (M < 1 || N % C::BN || K % 128 || K < 128 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap ma{};
  const cudaError_t e = encode_gemm_operand<T>(&ma, a, M, K, C::SLABS);
  if (e != cudaSuccess) return e;
  return launch_gemm_kernel<T, false>(ma, w, M, N, K, 1, 1, ep, s);
}

}  // namespace qasr
