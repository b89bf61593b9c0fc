// Encoder attention without the fused block: the packed kernel (K8) and the
// 4D kernel (K7), both softmax(q k^T over keys < t_real) v per head.
//
// qasr_packed_attention replaces qasr_ijcnlp_tpu/ops/flash.py
// `_packed_kernel`: heads packed at columns h * dh of the model's own (B, T,
// D) tensors.  qasr_flash_attention replaces `_attn_kernel` (behind
// `flash_attention`, `_flash_attention`): (B, H, T, dh) heads, which the
// port's caller hands over as strided views of the (B, T, D) projections, so
// here too nothing is transposed or copied.  The TPU kernels kept one (batch
// item, head group)'s whole K/V resident in VMEM and wrote a (128-query, Tk)
// fp32 logits tile per head, and the 4D one needed its q, k and v transposed
// and padded to 128-row tiles first; here the attention core of
// attention.cuh (shared with K4) walks the keys in 32-row shared-memory tiles
// with an online softmax, so neither the logits nor a padded or transposed
// copy of q, k or v is ever stored, Tq may differ from Tk, and keys at or
// past t_real are masked (the TPU 4D kernel had the same mask in its body,
// with t_real = Tk).  As in both TPU kernels the softmax denominator sums the
// unrounded fp32 p; p is rounded to the compute dtype only for the PV
// product.  q and k arrive pre-scaled by d_head^-0.25 (rounded to the compute
// dtype by the caller).  Any head width up to 256 runs.  Bound on the H100:
// 4 * B * H * Tq * t_real * dh FLOP on SIMT fp32 FMAs (no tensor cores yet),
// i.e. operations, not bytes.
#include "attention.cuh"

using namespace qasr;

namespace {

template <typename T>
int run_attention(const AttnArgs<T>& a, int B, int n_head, cudaStream_t s) {
  QASR_TRY((launch_attn_core<T, 0>(a, B, n_head, s)));
  return 0;
}

template <typename T>
int run_packed(const void* q, const void* k, const void* v, void* out, int B, int Tq, int Tk,
               int D, int n_head, int t_real, cudaStream_t s) {
  const int dh = D / n_head;
  const Strides sq = packed_strides(Tq, D, dh), skv = packed_strides(Tk, D, dh);
  const AttnArgs<T> a{(const T*)q, (const T*)k, (const T*)v, (T*)out, sq, skv, skv, sq,
                      Tq, Tk, t_real, dh};
  return run_attention<T>(a, B, n_head, s);
}

template <typename T>
int run_4d(const void* q, const void* k, const void* v, void* out, int B, int H, int Tq,
           int Tk, int dh, int t_real, const long long* st, cudaStream_t s) {
  const AttnArgs<T> a{(const T*)q, (const T*)k, (const T*)v, (T*)out,
                      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
                      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
                      Tq, Tk, t_real, dh};
  return run_attention<T>(a, B, H, s);
}

}  // namespace

// q (B, Tq, D), k and v (B, Tk, D), out (B, Tq, D), all row-major in the
// compute dtype, D = n_head * dh with dh <= 256, 1 <= t_real <= Tk.
extern "C" int qasr_packed_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int Tq, int Tk, int D, int n_head,
                                     int t_real, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32) return run_packed<float>(q, k, v, out, B, Tq, Tk, D, n_head, t_real, s);
  return run_packed<__nv_bfloat16>(q, k, v, out, B, Tq, Tk, D, n_head, t_real, s);
}

// q and out (B, H, Tq, dh), k and v (B, H, Tk, dh) in the compute dtype, each
// with unit column stride and the element strides (batch, head, row) given in
// that order for q, k, v and out in `strides` (12 values, host memory);
// dh <= 256, 1 <= t_real <= Tk.
extern "C" int qasr_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                    void* out, int B, int H, int Tq, int Tk, int dh,
                                    int t_real, const long long* strides, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return run_4d<float>(q, k, v, out, B, H, Tq, Tk, dh, t_real, strides, s);
  return run_4d<__nv_bfloat16>(q, k, v, out, B, H, Tq, Tk, dh, t_real, strides, s);
}
