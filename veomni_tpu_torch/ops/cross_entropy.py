"""Fused linear + cross-entropy, chunked over tokens.

Port of the ``xla_chunked`` impl of ``veomni_tpu/ops/cross_entropy.py``
(``:43-60``): the [T, V] logits are never materialized whole. Each chunk of
``chunk_size`` tokens runs under ``torch.utils.checkpoint``, so backward
recomputes that chunk's logits and peak memory is O(chunk * V).

Numerics: the reference computes the logits as f32
(``preferred_element_type=f32``, ``:28``) from bf16 operands. A bf16
``torch.matmul`` would round its output to bf16, so both operands are
upcast to f32 deliberately (exact for bf16 values) and the product runs in
full f32 (TF32 is off, see ``utils/device.py``). The logits then agree with
the reference's to f32 rounding of the accumulation order. The chunked
product stays ``torch.matmul``: the reference leaves it to XLA outside any
Pallas kernel.

``logit_softcap`` (gemma's ``final_logit_softcapping``) squashes the f32
logits to ``cap * tanh(logits / cap)`` before the softmax (``:29-30``).

Returns (loss_sum, valid_token_count); labels use -100 as ignore index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op

IGNORE_INDEX = -100


def _chunk_ce(h, lab, kernel_f32, logit_softcap: Optional[float] = None):
    logits = h.float() @ kernel_f32  # [C, V] f32
    if logit_softcap:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    valid = lab != IGNORE_INDEX
    lab_safe = torch.where(valid, lab, torch.zeros_like(lab))
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lab_safe[:, None].long())[:, 0]
    nll = torch.where(valid, logz - gold, torch.zeros_like(logz))
    return nll.sum(), valid.sum()


@KERNEL_REGISTRY.register("fused_linear_cross_entropy", "xla_chunked", priority=1)
def _flce_chunked(
    hidden, kernel, labels, *, chunk_size: int = 4096, logit_softcap: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [T,H], kernel [H,V], labels [T] -> (loss_sum f32, ntokens int)."""
    kernel_f32 = kernel.float()
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    ntokens = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for lo in range(0, hidden.shape[0], chunk_size):
        h = hidden[lo:lo + chunk_size]
        lab = labels[lo:lo + chunk_size]
        if torch.is_grad_enabled():
            nll, n = checkpoint(_chunk_ce, h, lab, kernel_f32, logit_softcap,
                                use_reentrant=False)
        else:
            nll, n = _chunk_ce(h, lab, kernel_f32, logit_softcap)
        loss_sum = loss_sum + nll
        ntokens = ntokens + n
    return loss_sum, ntokens


def fused_linear_cross_entropy(hidden, kernel, labels, **kwargs):
    return resolve_op("fused_linear_cross_entropy", hidden.device)(
        hidden, kernel, labels, **kwargs
    )
