"""Muon: momentum and Newton–Schulz orthogonalisation of the matrix updates.

Port of ``veomni_tpu/optim/muon.py``. The reference labels its leaves on
the layer-stacked parameter tree (``build_muon``, ``:79-86``): a leaf goes
to Muon when it has ``ndim >= 2`` there and its path names neither
``embed_tokens`` nor ``lm_head``; every other leaf goes to an unmasked
``optax.adamw(lr, weight_decay=wd)`` at optax's default betas and eps. Read
on that tree:

* a per-layer 1-D parameter (an RMSNorm weight, ``q_norm``/``k_norm``,
  Qwen2's q/k/v biases) is one ``[L, d]`` leaf there, so it goes to Muon
  and its L layers are orthogonalised JOINTLY, as one ``L x d`` matrix
  (``_orth`` reshapes ``[L, d]`` to ``[1, L, d]``). The port stacks those
  per-layer parameters, orthogonalises the stack and scatters the rows back;
* a per-layer matrix ``[L, m, n]`` (and a MoE expert ``[L, E, m, n]``, a
  router ``[L, d, E]``) is orthogonalised per layer (and per expert);
* only unstacked leaves with ``ndim < 2`` (the final ``norm``) and the
  embeddings go to AdamW, which decays them too (no mask) and ignores
  ``train.betas``/``train.eps``.

``ROADMAP.md`` queue 3 records both as mirrored on purpose. The
Newton–Schulz products are plain f32 matrix products (TF32 stays off,
``utils/device.py::resolve_device``); same-shaped matrices of all layers
go through one batched product, the math still per matrix.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5
NS_EPS = 1e-7
MOMENTUM = 0.95
ADAMW_BETAS = (0.9, 0.999)  # optax.adamw's defaults: the reference passes none
ADAMW_EPS = 1e-8


def newton_schulz(g: torch.Tensor, steps: int = NS_STEPS, eps: float = NS_EPS) -> torch.Tensor:
    """Orthogonalise a (batched) matrix ``[..., m, n]`` by the quintic
    iteration (``_newton_schulz``, ``:23-37``): Frobenius-normalise, then
    ``x <- a x + (b x xᵀ + c (x xᵀ)²) x``, on the transpose when m > n."""
    a, b, c = NS_COEFFS
    transpose = g.shape[-2] > g.shape[-1]
    x = g.mT if transpose else g
    x = x / (torch.linalg.matrix_norm(x, keepdim=True) + eps)
    for _ in range(steps):
        xxt = x @ x.mT
        bmat = b * xxt + c * (xxt @ xxt)
        x = a * x + bmat @ x
    return x.mT if transpose else x


def muon_label(path: str, ref_ndim: int) -> str:
    """``muon`` or ``adamw`` for a leaf of the reference's tree."""
    if "embed_tokens" in path or "lm_head" in path:
        return "adamw"
    return "muon" if ref_ndim >= 2 else "adamw"


def orthogonalize_leaves(effs: List[torch.Tensor]) -> List[torch.Tensor]:
    """``_orth`` over several reference leaves at once: each ``[..., m, n]``
    leaf becomes a batch of ``m x n`` matrices (the transposed ones turned
    to ``n x m`` first), matrices of one oriented shape go through one
    batched Newton–Schulz, and each comes back scaled by
    ``max(1, m / n) ** 0.5``."""
    by_shape: Dict[Tuple[int, int], List[Tuple[int, torch.Tensor]]] = {}
    for i, u in enumerate(effs):
        mats = u.reshape((-1,) + tuple(u.shape[-2:]))
        if mats.shape[-2] > mats.shape[-1]:
            mats = mats.mT
        by_shape.setdefault(tuple(mats.shape[-2:]), []).append((i, mats))
    out: List[torch.Tensor] = [None] * len(effs)
    for members in by_shape.values():
        batch = torch.cat([mats for _, mats in members]) if len(members) > 1 else members[0][1]
        orth = newton_schulz(batch)
        start = 0
        for i, mats in members:
            o = orth[start:start + mats.shape[0]]
            start += mats.shape[0]
            u = effs[i]
            m, n = u.shape[-2], u.shape[-1]
            if m > n:
                o = o.mT
            out[i] = o.reshape(u.shape) * (max(1.0, m / n) ** 0.5)
    return out
