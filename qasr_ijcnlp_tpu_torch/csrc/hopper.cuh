// Hopper building blocks shared by the tensor-core kernels: the attention
// core of K4, K7 and K8 (attention_tc.cuh) and the GEMM of K4's and
// K5/K6's projections, the conv stem and the mel frontend (gemm_tc.cuh);
// K9 (decode_attn.cu) takes the mbarriers and the 1D bulk copy; K11
// (attn_parts.cu) runs on the attention core, and K12 (step_formulations.cu)
// takes the mbarriers, both copies and Wgmma<8> / Wgmma<48>.
//
// * mbarrier helpers for a producer/consumer ring; a wait of over 10 s
//   traps, so a broken pipeline fails its launch instead of hanging the
//   card.
// * TMA (cp.async.bulk.tensor) loads of 3D, 4D and 5D boxes, and
//   cuTensorMapEncodeTiled, looked up in the already loaded libcuda with
//   dlsym (the library links only the CUDA runtime, no -lcuda); the 1D
//   bulk copy (cp.async.bulk, no tensor map) of a contiguous run of bytes
//   (K9's chunks of int8 codes and fp32 scales).
// * wgmma: shared-memory matrix descriptors (no swizzle, and the 128-byte
//   swizzle of a K-major operand whose rows are 128 bytes), and
//   Wgmma<N>::ss / ::rs, D (64 x N, fp32) += A B for one k-step of bf16
//   (k16) or TF32 (k8), N = 8, 16, 32, 48, 64 or 128; ::ss_mn, bf16 with A
//   read MN-major (its transpose bit set): core matrices of 8 K rows, each
//   16 bytes of 8 consecutive M elements, the descriptor's LBO along K and
//   SBO along M, as for an MN-major B.
// * tf32_rna (cvt.rna.tf32.f32), the split of an fp32 value into hi + lo
//   for 3xTF32 products.
#pragma once

#include <cuda.h>
#include <dlfcn.h>
#include <type_traits>

#include "common.cuh"

namespace qasr {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// of over 10 s is a broken pipeline: trap, so that the launch fails with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

// Generic-proxy writes to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// 1D bulk copy of ``bytes`` contiguous bytes from global to this block's
// shared memory, completing on ``bar`` (complete_tx).  ``dst``, ``src`` and
// ``bytes`` must be multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory matrix descriptor, no swizzle, K-major: 8-row x 16-byte core
// matrices; `lbo` bytes between core matrices along K, `sbo` along M/N.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo, int sbo = 128) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Descriptor of a K-major operand in the 128-byte swizzle that TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes: rows of 128 bytes, 8-row atoms of 1024
// bytes (the stride along M/N).  The tile must start on a 1024-byte
// boundary; a k-step inside the row advances the start address by its
// bytes (the swizzle is a function of the address bits).
__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The same swizzle with the strides given: a K-major operand whose 8-row
// groups along M/N lie ``sbo`` bytes apart (``lbo`` unused), or an MN-major
// one (64 consecutive M/N elements a 128-byte row, 8 K rows an atom) whose
// 64-element groups along M/N lie ``lbo`` apart and 8-row groups along K
// ``sbo`` apart.  Atoms start on 1024-byte boundaries.
__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define QASR_D4 "{%0, %1, %2, %3}"
#define QASR_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define QASR_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define QASR_D24                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23}"
#define QASR_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define QASR_D64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define QASR_O4(d) "+f"((d)[0]), "+f"((d)[1]), "+f"((d)[2]), "+f"((d)[3])
#define QASR_O8(d)                                                                  \
  "+f"((d)[0]), "+f"((d)[1]), "+f"((d)[2]), "+f"((d)[3]), "+f"((d)[4]), "+f"((d)[5]), \
      "+f"((d)[6]), "+f"((d)[7])
#define QASR_O16(d) QASR_O8(d), QASR_O8((d) + 8)
#define QASR_O24(d) QASR_O16(d), QASR_O8((d) + 16)
#define QASR_O32(d) QASR_O16(d), QASR_O16((d) + 16)
#define QASR_O64(d) QASR_O32(d), QASR_O32((d) + 32)
// A and B from shared memory (bf16 adds the two transpose flags: 0, 0, or
// 1, 0 for an MN-major A).
#define QASR_SS(SHAPE, TYPES, DL, A, B, P, TAIL)                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\nwgmma.mma_async.sync.aligned." SHAPE \
  ".f32." TYPES " " DL ", %" #A ", %" #B ", p, 1, 1" TAIL ";\n}\n"
// A from four registers, B from shared memory (bf16 adds B's transpose flag).
#define QASR_RS(SHAPE, TYPES, DL, A0, A1, A2, A3, B, P, TAIL)                       \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\nwgmma.mma_async.sync.aligned." SHAPE \
  ".f32." TYPES " " DL ", {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1" TAIL \
  ";\n}\n"

// D (64 x N, fp32, accumulated) += A B for one k-step: bf16 k16 or tf32 k8.
template <int N>
struct Wgmma;

#define QASR_WGMMA(N, DL, OUT, NA, NB, NP, RA0, RA1, RA2, RA3, RB, RP)                     \
  template <>                                                                             \
  struct Wgmma<N> {                                                                       \
    static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, __nv_bfloat16) { \
      asm volatile(QASR_SS("m64n" #N "k16", "bf16.bf16", DL, NA, NB, NP, ", 0, 0")         \
                   : OUT(d)                                                                \
                   : "l"(a), "l"(b), "r"(1));                                              \
    }                                                                                     \
    static __device__ __forceinline__ void ss_mn(float* d, uint64_t a, uint64_t b) {       \
      asm volatile(QASR_SS("m64n" #N "k16", "bf16.bf16", DL, NA, NB, NP, ", 1, 0")         \
                   : OUT(d)                                                                \
                   : "l"(a), "l"(b), "r"(1));                                              \
    }                                                                                     \
    static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b, float) {   \
      asm volatile(QASR_SS("m64n" #N "k8", "tf32.tf32", DL, NA, NB, NP, "")                \
                   : OUT(d)                                                                \
                   : "l"(a), "l"(b), "r"(1));                                              \
    }                                                                                     \
    static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b,     \
                                              __nv_bfloat16) {                             \
      asm volatile(QASR_RS("m64n" #N "k16", "bf16.bf16", DL, RA0, RA1, RA2, RA3, RB, RP,   \
                           ", 1")                                                          \
                   : OUT(d)                                                                \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));          \
    }                                                                                     \
    static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t b,     \
                                              float) {                                     \
      asm volatile(QASR_RS("m64n" #N "k8", "tf32.tf32", DL, RA0, RA1, RA2, RA3, RB, RP, "") \
                   : OUT(d)                                                                \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));          \
    }                                                                                     \
  };

QASR_WGMMA(8, QASR_D4, QASR_O4, 4, 5, 6, 4, 5, 6, 7, 8, 9)
QASR_WGMMA(16, QASR_D8, QASR_O8, 8, 9, 10, 8, 9, 10, 11, 12, 13)
QASR_WGMMA(32, QASR_D16, QASR_O16, 16, 17, 18, 16, 17, 18, 19, 20, 21)
QASR_WGMMA(48, QASR_D24, QASR_O24, 24, 25, 26, 24, 25, 26, 27, 28, 29)
QASR_WGMMA(64, QASR_D32, QASR_O32, 32, 33, 34, 32, 33, 34, 35, 36, 37)
QASR_WGMMA(128, QASR_D64, QASR_O64, 64, 65, 66, 64, 65, 66, 67, 68, 69)

// ---------------------------------------------------------------- host -----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the CUDA runtime has
// already loaded; the library links only the runtime, so it looks the
// function up there.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

}  // namespace qasr
