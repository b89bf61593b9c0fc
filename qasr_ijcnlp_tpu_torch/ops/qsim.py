"""Closed-form batched statevector simulation of the QuantumConv1d circuit.

Port of ``qasr_ijcnlp_tpu/ops/qsim.py``.  The circuit is fixed:

    AmplitudeEmbedding(pad(x), normalize=True)
    Rot(phi_i, theta_i, omega_i) on each wire i
    CNOT(i, i+1) chain
    expval(PauliZ(i)) for each wire

so it collapses to one precomposed unitary ``U`` (the CNOT chain is a basis
permutation) and the expectations to two products over the whole batch:

    psi    = x / ||x||               (real; only the first m entries nonzero)
    phi    = U[:, :m] @ psi           (complex, kept as real and imaginary
                                       f32 parts)
    <Z_i>  = (phi_r^2 + phi_i^2) @ Zdiag

Plain PyTorch, differentiable by autograd in the angles and the inputs.  The
JAX function is jnp (no Pallas kernel), and the port gives it no kernel of
its own: on the card it runs as a handful of PyTorch ops.  The basis
permutation and the Z table are numpy tables built once per qubit count and
moved to each device once.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def cnot_chain_permutation(n_qubits: int) -> np.ndarray:
    """sigma with U = R[sigma] for the circuit-ordered CNOT(0,1)..CNOT(n-2,n-1).

    Wire 0 is the most significant bit of the basis index (PennyLane's
    convention).  Returns the inverse map f^-1 as an index array, where f(b)
    applies the chain's controlled flips to basis state b."""
    dim = 1 << n_qubits
    f = np.arange(dim)
    for i in range(n_qubits - 1):
        ctrl_bit = n_qubits - 1 - i  # wire i, MSB-first
        tgt_bit = n_qubits - 2 - i  # wire i+1
        ctrl_set = (f >> ctrl_bit) & 1
        f = np.where(ctrl_set == 1, f ^ (1 << tgt_bit), f)
    # C[f(b), b] = 1, so (C R)[f(b), :] = R[b, :]  =>  U = R[argsort(f)].
    return np.argsort(f)


@functools.lru_cache(maxsize=None)
def pauli_z_diagonal(n_qubits: int) -> np.ndarray:
    """(2^n, n) matrix of z_i(b) = +/-1 so that expvals = probs @ Z."""
    dim = 1 << n_qubits
    b = np.arange(dim)
    z = np.empty((dim, n_qubits), np.float32)
    for i in range(n_qubits):
        bit = (b >> (n_qubits - 1 - i)) & 1  # wire i is MSB-first
        z[:, i] = 1.0 - 2.0 * bit
    return z


@functools.lru_cache(maxsize=None)
def _tables(n_qubits: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The permutation (int64) and the Z table (f32) on ``device``, moved
    there once per qubit count."""
    sigma = torch.from_numpy(cnot_chain_permutation(n_qubits)).to(device)
    z = torch.from_numpy(pauli_z_diagonal(n_qubits)).to(device)
    return sigma, z


def rot_matrices(weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-wire Rot(phi, theta, omega) = RZ(omega) RY(theta) RZ(phi).

    weights: (n, 3) angles.  Returns real and imaginary parts, each (n, 2, 2)."""
    phi, theta, omega = weights[:, 0], weights[:, 1], weights[:, 2]
    c = torch.cos(theta / 2)
    s = torch.sin(theta / 2)
    # Rot = [[e^{-i(phi+omega)/2} c, -e^{ i(phi-omega)/2} s],
    #        [e^{-i(phi-omega)/2} s,  e^{ i(phi+omega)/2} c]]
    a = (phi + omega) / 2
    d = (phi - omega) / 2
    re = torch.stack([
        torch.stack([torch.cos(a) * c, -torch.cos(d) * s], dim=-1),
        torch.stack([torch.cos(d) * s, torch.cos(a) * c], dim=-1),
    ], dim=-2)
    im = torch.stack([
        torch.stack([-torch.sin(a) * c, -torch.sin(d) * s], dim=-1),
        torch.stack([-torch.sin(d) * s, torch.sin(a) * c], dim=-1),
    ], dim=-2)
    return re, im


def circuit_unitary(weights: torch.Tensor, n_qubits: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The full circuit unitary U = CNOT-chain . (kron_i Rot_i) as (U_re,
    U_im), each (2^n, 2^n); differentiable in ``weights``."""
    re, im = rot_matrices(weights)
    u_re, u_im = re[0], im[0]
    for i in range(1, n_qubits):
        # complex kron in real arithmetic
        u_re, u_im = (
            torch.kron(u_re, re[i]) - torch.kron(u_im, im[i]),
            torch.kron(u_re, im[i]) + torch.kron(u_im, re[i]),
        )
    sigma, _ = _tables(n_qubits, weights.device)
    return u_re[sigma], u_im[sigma]


def quantum_expvals(inputs: torch.Tensor, weights: torch.Tensor, n_qubits: int,
                    eps: float = 1e-12) -> torch.Tensor:
    """<Z_i> for a batch of circuit inputs.

    inputs: (..., m) real with m <= 2^n (zero-padded amplitude embedding);
    weights: (n_qubits, 3).  Returns (..., n_qubits) float32.

    The squared norm is clamped to ``eps**2`` inside the sqrt, so an
    all-zero window gives all-zero expvals with finite gradients (a clamp
    after the sqrt would not help: sqrt's gradient at 0 is already
    infinite)."""
    m = inputs.shape[-1]
    if m > 1 << n_qubits:
        raise ValueError(f"amplitude input length {m} exceeds 2^{n_qubits}")
    norm = torch.sqrt(torch.clamp_min((inputs * inputs).sum(-1, keepdim=True), eps * eps))
    psi = inputs / norm  # (..., m)
    u_re, u_im = circuit_unitary(weights, n_qubits)  # (dim, dim)
    # Only the first m columns of U meet nonzero amplitudes.
    phi_re = psi @ u_re[:, :m].t()  # (..., dim)
    phi_im = psi @ u_im[:, :m].t()
    probs = phi_re * phi_re + phi_im * phi_im
    _, z = _tables(n_qubits, inputs.device)
    return (probs @ z.to(probs.dtype)).float()
