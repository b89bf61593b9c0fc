// Packed encoder attention (K8): softmax(q k^T over keys < t_real) v on the
// model's own (B, T, D) tensors, heads packed at columns h * 64.
//
// Replaces qasr_ijcnlp_tpu/ops/flash.py `_packed_kernel`.  The TPU kernel
// kept one (batch item, head pair)'s whole K/V resident in VMEM and wrote a
// (128-query, Tk) fp32 logits tile per head; here the attention core of
// attention.cuh (shared with K4) walks the keys in 32-row shared-memory
// tiles with an online softmax, so neither the logits nor a padded copy of
// q, k or v is ever stored, and Tq may differ from Tk.  As in the TPU kernel
// the softmax denominator sums the unrounded fp32 p; p is rounded to the
// compute dtype only for the PV product.  q and k arrive pre-scaled by
// d_head^-0.25 (rounded to the compute dtype by the caller).  Bound on the
// H100: 4 * B * H * Tq * t_real * 64 FLOP on SIMT fp32 FMAs (no tensor cores
// yet), i.e. operations, not bytes.
#include "attention.cuh"

using namespace qasr;

namespace {

template <typename T>
int run_packed(const T* q, const T* k, const T* v, T* out, int B, int Tq, int Tk, int D,
               int n_head, int t_real, cudaStream_t s) {
  QASR_TRY((launch_attn_core<T, 0>(q, D, k, D, v, D, out, D, B, Tq, Tk, n_head, t_real, s)));
  return 0;
}

}  // namespace

// q (B, Tq, D), k and v (B, Tk, D), out (B, Tq, D), all row-major in the
// compute dtype, D = n_head * 64, 1 <= t_real <= Tk.
extern "C" int qasr_packed_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int Tq, int Tk, int D, int n_head,
                                     int t_real, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return run_packed<float>((const float*)q, (const float*)k, (const float*)v, (float*)out,
                             B, Tq, Tk, D, n_head, t_real, s);
  using bf = __nv_bfloat16;
  return run_packed<bf>((const bf*)q, (const bf*)k, (const bf*)v, (bf*)out, B, Tq, Tk, D,
                        n_head, t_real, s);
}
