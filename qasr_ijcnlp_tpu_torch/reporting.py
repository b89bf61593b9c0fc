"""Reporting: prediction analysis, metric plots, result JSONs, headers.

Port of ``qasr_ijcnlp_tpu/reporting.py``: ``analyze_predictions``,
``plot_cer_distribution``, ``plot_metrics_distribution``,
``plot_training_results``, ``save_results_json``, ``print_model_info`` and
``print_training_header``.  Matplotlib runs on its Agg backend; where it is
not installed the plots are skipped (None).
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict, List

import numpy as np

from . import metrics as qmetrics


def analyze_predictions(predictions: List[str], targets: List[str], num_samples: int = 5,
                        log=print) -> List[Dict]:
    """Show the best and worst samples by per-sample CER."""
    rows = []
    for pred, tgt in zip(predictions, targets):
        cer = (qmetrics.levenshtein(tgt, pred) / len(tgt) if len(tgt)
               else (0.0 if not pred else 1.0))
        rows.append({"prediction": pred, "target": tgt, "cer": cer})
    ordered = sorted(rows, key=lambda r: r["cer"])
    log(f"\nBest {num_samples} predictions:")
    for r in ordered[:num_samples]:
        log(f"  CER={r['cer']:.3f}  '{r['prediction'][:60]}' vs '{r['target'][:60]}'")
    log(f"\nWorst {num_samples} predictions:")
    for r in ordered[-num_samples:]:
        log(f"  CER={r['cer']:.3f}  '{r['prediction'][:60]}' vs '{r['target'][:60]}'")
    return rows


def _plt():
    """pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_cer_distribution(cers: List[float], save_path: str = "cer_distribution.png"):
    plt = _plt() if cers else None
    if plt is None:
        return None  # nothing to plot, or no matplotlib
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(cers, bins=30, edgecolor="black", alpha=0.75)
    ax.axvline(float(np.mean(cers)), linestyle="--", color="red",
               label=f"mean {np.mean(cers):.3f}")
    ax.set_xlabel("Character Error Rate")
    ax.set_ylabel("Count")
    ax.set_title("CER distribution")
    ax.legend()
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def plot_metrics_distribution(per_sample: Dict[str, List[float]],
                              save_path: str = "metrics_distribution.png"):
    """One histogram panel per metric."""
    names = [n for n in per_sample if len(per_sample[n])]
    plt = _plt() if names else None
    if plt is None:
        return None  # nothing to plot, or no matplotlib
    fig, axes = plt.subplots(1, len(names), figsize=(6 * len(names), 4.5))
    if len(names) == 1:
        axes = [axes]
    for ax, name in zip(axes, names):
        vals = per_sample[name]
        ax.hist(vals, bins=30, edgecolor="black", alpha=0.75)
        ax.axvline(float(np.mean(vals)), linestyle="--", color="red",
                   label=f"mean {np.mean(vals):.3f}")
        ax.set_title(name)
        ax.legend()
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def plot_training_results(history_epochs: List[dict],
                          save_path: str = "training_results.png"):
    """One panel per logged metric over the epochs of a
    ``TrainingHistory``."""
    keys = [k for k in history_epochs[0] if k not in ("epoch", "time_s")] \
        if history_epochs else []
    plt = _plt() if keys else None
    if plt is None:
        return None  # nothing to plot, or no matplotlib
    cols = min(len(keys), 3)
    rows = (len(keys) + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 4 * rows), squeeze=False)
    xs = [e.get("epoch", i) for i, e in enumerate(history_epochs)]
    for i, key in enumerate(keys):
        ax = axes[i // cols][i % cols]
        ax.plot(xs, [e.get(key) for e in history_epochs], marker="o")
        ax.set_xlabel("epoch")
        ax.set_title(key)
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def save_results_json(path: str, results: dict) -> str:
    """A timestamped result JSON."""
    results = {**results, "timestamp": datetime.now().isoformat()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2, default=float)
    return path


def print_model_info(name: str, n_params: int, n_trainable: int, log=print):
    log(f"Model: {name}")
    log(f"  total parameters:     {n_params:,}")
    log(f"  trainable parameters: {n_trainable:,}"
        f" ({100.0 * n_trainable / max(n_params, 1):.2f}%)")


def print_training_header(task: str, epochs: int, lr: float, batch_size: int, log=print):
    log("=" * 60)
    log(f"Training: {task}")
    log(f"  epochs={epochs}  lr={lr}  batch_size={batch_size}  backend={_backend_name()}")
    log("=" * 60)


def _backend_name() -> str:
    import torch

    if torch.cuda.is_available():
        return f"cuda x{torch.cuda.device_count()}"
    return "cpu x1"
