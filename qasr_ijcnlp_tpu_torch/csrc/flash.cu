// Encoder attention without the fused block: the packed kernel (K8) and the
// 4D kernel (K7), both softmax(q k^T over keys < t_real) v per head, on the
// tensor-core core of attention_tc.cuh (wgmma, a TMA ring, 3xTF32 in f32).
//
// qasr_packed_attention replaces qasr_ijcnlp_tpu/ops/flash.py
// `_packed_kernel`: heads packed at columns h * dh of the model's own (B, T,
// D) tensors.  qasr_flash_attention replaces `_attn_kernel` (behind
// `flash_attention`, `_flash_attention`): (B, H, T, dh) heads, which the
// port's caller hands over as strided views of the (B, T, D) projections, so
// here too nothing is transposed or copied in device memory.  The TPU
// kernels kept one (batch item, head group)'s whole K/V resident in VMEM and
// wrote a (128-query, Tk) fp32 logits tile per head, and the 4D one needed
// its q, k and v transposed and padded to 128-row tiles first; here one
// block owns 64 or 128 query rows of one head and walks the keys in 16- to
// 64-row tiles that TMA brings into shared memory with an online softmax, so
// neither the logits nor a padded copy of q, k or v is ever stored, Tq may
// differ from Tk, and keys at or past t_real are masked (the TPU 4D kernel
// had the same mask in its body, with t_real = Tk).  As in both TPU kernels
// the softmax denominator sums the unrounded fp32 p; p is rounded to the
// compute dtype only for the PV product.  q and k arrive pre-scaled by
// d_head^-0.25 (rounded to the compute dtype by the caller).  Any head width
// up to 256 runs.  Bound on the H100: 4 * B * H * min(Tq, t_real) * t_real
// * dh FLOP on the tensor cores, at 989 TFLOP/s in bf16 and 495 / 3 in f32
// (three TF32 products each), i.e. operations, not bytes.
#include "attention_tc.cuh"

using namespace qasr;

// q (B, Tq, D), k and v (B, Tk, D), out (B, Tq, D), all row-major in the
// compute dtype, D = n_head * dh with dh <= 256, 1 <= t_real <= Tk.
extern "C" int qasr_packed_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* out, int B, int Tq, int Tk, int D, int n_head,
                                     int t_real, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long dh = D / n_head, sq = (long long)Tq * D, skv = (long long)Tk * D;
  const TcArgs a{TcOperand{q, sq, dh, D}, TcOperand{k, skv, dh, D}, TcOperand{v, skv, dh, D},
                 out, sq, dh, D, Tq, t_real, (int)dh, 0};
  if (dtype == kF32) return (int)launch_attn_tc<float>(a, B, n_head, s);
  return (int)launch_attn_tc<__nv_bfloat16>(a, B, n_head, s);
}

// q and out (B, H, Tq, dh), k and v (B, H, Tk, dh) in the compute dtype, each
// with unit column stride and the element strides (batch, head, row) given in
// that order for q, k, v and out in `st` (12 values, host memory);
// dh <= 256, 1 <= t_real <= Tk (only keys < t_real are read, so Tk itself
// is not needed).
extern "C" int qasr_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                    void* out, int B, int H, int Tq, int Tk, int dh,
                                    int t_real, const long long* st, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  (void)Tk;
  const TcArgs a{TcOperand{q, st[0], st[1], st[2]}, TcOperand{k, st[3], st[4], st[5]},
                 TcOperand{v, st[6], st[7], st[8]}, out, st[9], st[10], st[11],
                 Tq, t_real, dh, 0};
  if (dtype == kF32) return (int)launch_attn_tc<float>(a, B, H, s);
  return (int)launch_attn_tc<__nv_bfloat16>(a, B, H, s);
}
