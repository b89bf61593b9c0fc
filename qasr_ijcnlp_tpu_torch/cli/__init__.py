"""Command-line entry points of the port (``python -m
qasr_ijcnlp_tpu_torch.cli.<name>``), with the JAX package's flags."""

from __future__ import annotations


def resolve_device(spec: str = "auto") -> str:
    """``--device``: ``auto`` and ``cuda`` are the card, and exit with an
    error when torch sees none (the port does not move to the CPU on its
    own); ``cpu`` is the CPU."""
    import torch

    if spec == "cpu":
        return "cpu"
    if spec not in ("auto", "cuda") and not spec.startswith("cuda:"):
        raise SystemExit(f"--device must be auto, cuda or cpu, got {spec!r}")
    if not torch.cuda.is_available():
        raise SystemExit(f"--device {spec}: torch sees no CUDA device; pass --device cpu "
                         "to run on the CPU")
    return "cuda" if spec == "auto" else spec


def load_model_with_fallback(name: str, compute_dtype: str = "float32", device="cuda",
                             download_root=None):
    """The checkpoint (a path, or an official name cached locally), else a
    random initialization with a loud warning."""
    from ..models.registry import load_model

    model = load_model(name, download_root=download_root, compute_dtype=compute_dtype,
                       init_if_missing=True, device=device)
    if "random-init" in model.name:
        print(
            f"WARNING: no checkpoint of '{name}' here (this package does not "
            "download); using random initialization - metrics will be "
            "meaningless, but the pipeline is exercised end-to-end."
        )
    return model


def load_checkpoint_into(module, state_dict, device):
    """``module`` holding ``state_dict`` (names and shapes must match, as the
    JAX package restores onto a target tree) on ``device``, frozen.  The
    tensors replace the module's own (``assign``), so weight packs kept for
    the old ones are rebuilt at first use."""
    module.load_state_dict({k: v.to(device) for k, v in state_dict.items()}, strict=True,
                           assign=True)
    return module.to(device).eval().requires_grad_(False)
