"""MoE router auxiliary load-balancing loss (switch-transformer style).

Port of ``veomni_tpu/ops/load_balancing.py``: plain torch, registered as
``load_balancing_loss``/``xla`` (the reference fuses it in XLA; no kernel).
"""

from __future__ import annotations

import torch.nn.functional as F

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op


@KERNEL_REGISTRY.register("load_balancing_loss", "xla")
def _lbl_xla(router_probs, expert_index, num_experts: int, valid_mask=None):
    """router_probs [T,E] softmax probs; expert_index [T,K] chosen experts.

    loss = E * sum_e( frac_tokens_e * mean_prob_e ) over valid tokens.
    """
    t = router_probs.shape[0]
    dispatch = F.one_hot(expert_index.long(), num_experts).float().sum(1)  # [T,E]
    if valid_mask is not None:
        m = valid_mask[:, None].float()
        dispatch = dispatch * m
        router_probs = router_probs * m
        denom = valid_mask.sum().clamp(min=1).float()
    else:
        denom = float(t)
    frac = dispatch.sum(0) / (denom * expert_index.shape[-1])
    prob = router_probs.sum(0) / denom
    return num_experts * (frac * prob).sum()


def load_balancing_loss(router_probs, expert_index, num_experts: int, valid_mask=None):
    return resolve_op("load_balancing_loss", router_probs.device)(
        router_probs, expert_index, num_experts, valid_mask
    )
