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

:func:`fused_linear_cross_entropy` returns (loss_sum, valid_token_count);
labels use -100 as ignore index. The post-training ops keep one value per
token: :func:`fused_linear_cross_entropy_per_token` (``:69-92``, the
channel-loss and RL path) and :func:`fused_linear_topk_distill`
(``:100-203``, top-k forward-KL distillation), chunked and checkpointed the
same way.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op

IGNORE_INDEX = -100


def _chunk_logits(h, kernel_f32, logit_softcap: Optional[float]):
    logits = h.float() @ kernel_f32  # [C, V] f32
    if logit_softcap:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    return logits


def _gold(logits, lab):
    """(valid mask, the label's logit; 0-index where ignored)."""
    valid = lab != IGNORE_INDEX
    lab_safe = torch.where(valid, lab, torch.zeros_like(lab))
    return valid, logits.gather(-1, lab_safe[:, None].long())[:, 0]


def _chunk_ce_per_token(h, lab, kernel_f32, logit_softcap: Optional[float] = None):
    """Per-token NLL [C] (0 where ignored) and the valid mask."""
    logits = _chunk_logits(h, kernel_f32, logit_softcap)
    valid, gold = _gold(logits, lab)
    logz = torch.logsumexp(logits, dim=-1)
    return torch.where(valid, logz - gold, torch.zeros_like(logz)), valid


def _chunk_ce(h, lab, kernel_f32, logit_softcap: Optional[float] = None):
    nll, valid = _chunk_ce_per_token(h, lab, kernel_f32, logit_softcap)
    return nll.sum(), valid.sum()


def _chunked(fn, chunk_size: int, *tensors):
    """``fn`` over token chunks of ``tensors`` (each [T, ...]): checkpointed
    while grad is on, so backward recomputes a chunk's logits; plain under
    ``torch.no_grad``. Returns the per-chunk outputs."""
    outs = []
    for lo in range(0, tensors[0].shape[0], chunk_size):
        chunk = [t[lo:lo + chunk_size] for t in tensors]
        if torch.is_grad_enabled():
            outs.append(checkpoint(fn, *chunk, use_reentrant=False))
        else:
            outs.append(fn(*chunk))
    return outs


@KERNEL_REGISTRY.register("fused_linear_cross_entropy", "xla_chunked", priority=1)
def _flce_chunked(
    hidden, kernel, labels, *, chunk_size: int = 4096, logit_softcap: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [T,H], kernel [H,V], labels [T] -> (loss_sum f32, ntokens int)."""
    kernel_f32 = kernel.float()
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    ntokens = torch.zeros((), dtype=torch.int64, device=hidden.device)
    body = functools.partial(_chunk_ce, kernel_f32=kernel_f32, logit_softcap=logit_softcap)
    for nll, n in _chunked(body, chunk_size, hidden, labels):
        loss_sum = loss_sum + nll
        ntokens = ntokens + n
    return loss_sum, ntokens


def fused_linear_cross_entropy(hidden, kernel, labels, **kwargs):
    return resolve_op("fused_linear_cross_entropy", hidden.device)(
        hidden, kernel, labels, **kwargs
    )


def fused_linear_cross_entropy_per_token(
    hidden, kernel, labels, *, chunk_size: int = 4096, logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Per-token NLL [T] f32, 0 where ignored (``:69-92``: the channel-loss
    and RL path)."""
    body = functools.partial(_chunk_ce_per_token, kernel_f32=kernel.float(),
                             logit_softcap=logit_softcap)
    return torch.cat([nll for nll, _ in _chunked(body, chunk_size, hidden, labels)])


# --------------------------------------------------------------- distillation
DISTILL_OUTPUTS = ("log_probs", "entropy", "distill", "student_mass", "teacher_mass", "nll")


def _chunk_distill_body(h, lab, t_ids, t_lp, kernel_f32, temperature: float,
                        log_prob_min_clamp: Optional[float], logit_softcap: Optional[float]):
    """One token chunk of the top-k forward-KL outputs (``:100-149``): the
    student's log-probs gathered at the teacher's top-k ids, the KL on that
    support, the untempered gold NLL, and the two mass terms, which are
    metrics only (detached). Autograd derives the backward of this body, as
    ``jax.checkpoint`` does in the reference."""
    logits = _chunk_logits(h, kernel_f32, logit_softcap)  # [C, V] f32
    valid, raw_gold = _gold(logits, lab)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    raw_logz = torch.logsumexp(logits, dim=-1)
    nll = torch.where(valid, raw_logz - raw_gold, zero)
    if temperature != 1.0:
        logits = logits / temperature
        logz = torch.logsumexp(logits, dim=-1)
        gold = _gold(logits, lab)[1]
    else:
        logz, gold = raw_logz, raw_gold
    log_probs = torch.where(valid, gold - logz, zero)
    probs = torch.softmax(logits, dim=-1)
    entropy = torch.where(valid, logz - (probs * logits).sum(-1), zero)
    s_lp = logits.gather(-1, t_ids.long()) - logz[:, None]  # [C, K]
    t_lp32 = t_lp.float()
    if log_prob_min_clamp is not None:  # jnp.maximum: a tie splits the gradient
        floor = torch.tensor(log_prob_min_clamp, dtype=s_lp.dtype, device=s_lp.device)
        s_lp = torch.maximum(s_lp, floor)
        t_lp32 = torch.maximum(t_lp32, floor)
    p_teacher = torch.exp(t_lp32)
    distill = torch.where(valid, (p_teacher * (t_lp32 - s_lp)).sum(-1), zero)
    student_mass = torch.where(valid, torch.exp(s_lp).sum(-1), zero)
    teacher_mass = torch.where(valid, p_teacher.sum(-1), zero)
    return log_probs, entropy, distill, student_mass.detach(), teacher_mass.detach(), nll


@KERNEL_REGISTRY.register("fused_linear_topk_distill", "xla_chunked", priority=1)
def _topk_distill_chunked(
    hidden, kernel, labels, teacher_topk_ids, teacher_topk_log_probs, *,
    chunk_size: int = 1024, temperature: float = 1.0,
    log_prob_min_clamp: Optional[float] = None, logit_softcap: Optional[float] = None,
) -> Dict[str, torch.Tensor]:
    """Chunked fused linear + top-k forward-KL distillation (``:152-196``).

    hidden [T,H], kernel [H,V], labels [T] (pre-shifted), teacher top-k ids
    and log-probs [T,K] aligned with the labels. Returns per-token [T] f32
    tensors, 0 at ignored positions: ``log_probs`` (gold, tempered),
    ``entropy``, ``distill`` (forward KL on the top-k support),
    ``student_mass`` and ``teacher_mass`` (detached), and ``nll`` (the
    untempered gold NLL: the CE term of a CE + KL objective, from the same
    [T,V] product). ``logit_softcap`` caps the logits as ``head_loss`` does;
    the reference has no such argument and leaves the cap out (ROADMAP.md
    queue 3, diverges on purpose 7): at None the two agree."""
    body = functools.partial(_chunk_distill_body, kernel_f32=kernel.float(),
                             temperature=temperature, log_prob_min_clamp=log_prob_min_clamp,
                             logit_softcap=logit_softcap)
    chunks = _chunked(body, chunk_size, hidden, labels, teacher_topk_ids,
                      teacher_topk_log_probs)
    return {name: torch.cat([c[i] for c in chunks]) for i, name in enumerate(DISTILL_OUTPUTS)}


def fused_linear_topk_distill(hidden, kernel, labels, teacher_topk_ids, teacher_topk_log_probs,
                              **kwargs) -> Dict[str, torch.Tensor]:
    return resolve_op("fused_linear_topk_distill", hidden.device)(
        hidden, kernel, labels, teacher_topk_ids, teacher_topk_log_probs, **kwargs
    )
