"""Hand-written Hopper kernels of the request path and their plain versions.

Each module pairs one kernel wrapper with a plain PyTorch version of the
same function.  The wrapper takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel (``csrc/``, built by
:mod:`qasr_ijcnlp_tpu_torch._kernels`) or raises.  Each wrapper counts its
launches in a plain module-level int.

* :mod:`.melfront` — STFT + mel frontend (K1)
* :mod:`.conv_stem` — two-conv encoder stem (K2, and K3 at 512 < D <= 1024)
* :mod:`.encoder_block` — LN + QKV + masked attention (K4) and
  out-proj + LN + MLP (K5, and K6 at D > 512)
* :mod:`.flash` — attention on packed (B, T, D) heads (K8) and on
  (B, H, T, dh) heads that do not pack (K7), both on the tensor cores
* :mod:`.decode_attn` — the decode loop's int8 cross attention (K9) and
  ``quantize_kv``, behind ``DecodingOptions(kv_int8=True)``
* :mod:`.decoder_step` — the opt-in fused decoder-layer step (K10), one
  launch per layer per token; ``set_fused_decoder_step(True)`` turns it on

The encoder's kernels (K2-K8) have gradients: where grad mode is on and an
input requires grad, the wrapper calls its ``torch.autograd.Function``,
whose forward is the kernel and whose backward is the VJP of the plain
version recomputed from the saved inputs (:func:`plain_vjp`).  That is the
JAX package's rule: none of its Pallas kernels has a backward, and each
custom VJP differentiates the XLA form.  Inference never takes the
Function, so its launches are as before.

The encoder-path kernels (K1-K8) are also ``torch.library`` custom ops in
the ``qasr`` namespace (:mod:`.library`), so that ``torch.export`` records
them as nodes of a program (``export.py``, ``with_kernels=True``).  The
wrappers call the ops only while :func:`recording_ops` is on; otherwise
they launch as before.
"""

import contextlib

import torch
import torch.nn.functional as F

# The widest head the attention kernels take (csrc/attention_tc.cuh for K7
# and K8, csrc/decode_attn.cu for K9; K4 takes the fused-block gate's heads
# of 64 and 128 on the same core).
MAX_HEAD_WIDTH = 256

_RECORD_OPS = False


@contextlib.contextmanager
def record_ops():
    """While on, the encoder-path wrappers call their ``qasr::`` custom ops
    (:mod:`.library`) instead of launching: ``torch.export`` traces them
    as opaque nodes whose bodies launch the kernels at run time."""
    global _RECORD_OPS
    from . import library  # noqa: F401  (registers the ops)

    prev, _RECORD_OPS = _RECORD_OPS, True
    try:
        yield
    finally:
        _RECORD_OPS = prev


def recording_ops() -> bool:
    return _RECORD_OPS


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``x`` (kernel tile padding)."""
    return (x + m - 1) // m * m


def kernel_head_width(name: str, d_model: int, n_head: int) -> int:
    """``d_model // n_head``; raise where the heads do not split ``d_model``
    evenly or are wider than the attention kernels take."""
    if n_head < 1 or d_model % n_head or d_model // n_head > MAX_HEAD_WIDTH:
        raise ValueError(f"{name}: {n_head} heads over D={d_model} are not equal heads "
                         f"of width <= {MAX_HEAD_WIDTH}")
    return d_model // n_head


def head_scale(d_head: int, dtype) -> float:
    """The attention factor d_head^-0.25 rounded to ``dtype``.

    JAX multiplies a bf16 array by a Python float after rounding the float
    to bf16 (weak typing); PyTorch would multiply in fp32 and round once.
    Rounding the factor first makes the two products equal bit for bit."""
    return float(torch.tensor(d_head ** -0.25, dtype=dtype))


def layer_norm(x, ln, eps: float = 1e-5):
    """LayerNorm in fp32 whatever the activation dtype; result in x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * ln.weight.float() + ln.bias.float()).to(x.dtype)


def linear(x, lin):
    """x @ W^T + b with the nn.Linear parameters cast to x.dtype per call."""
    y = x @ lin.weight.to(x.dtype).t()
    if lin.bias is not None:
        y = y + lin.bias.to(x.dtype)
    return y


def gelu(x):
    """Exact-erf GELU computed in fp32, result in x.dtype."""
    return F.gelu(x.float()).to(x.dtype)


def wants_grad(*tensors) -> bool:
    """Whether autograd must record a kernel call: grad mode on and an
    input that requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def plain_vjp(ctx, plain, grad):
    """The backward of a kernel's ``autograd.Function``: the VJP of
    ``plain(*saved)`` at the inputs it saved, recomputed under grad mode.
    Returns one gradient per saved tensor (None where the input needs
    none), in the order they were saved, first among ``forward``'s
    arguments."""
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*xs)
        wrt = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True,
                                         materialize_grads=True))
    return tuple(next(grads) if n else None for n in needs)
