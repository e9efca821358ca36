"""Expert-parallel MoE token dispatch.

Port of ``veomni_tpu/parallel/moe.py``. Each ep rank holds ``E/ep``
experts (the expert dim of every expert weight is split over ``ep``; their
feature dim over ``ep_fsdp`` when it divides, see
``parallel/parallel_plan.py``). The reference's capacity-bucketed
``lax.all_to_all`` inside a ``shard_map`` becomes, per rank:

  1. routing on the rank's tokens (``models/transformer.py::route_tokens``,
     every dialect); its load-balancing loss is the reference's global one,
     from per-expert statistics summed over dp×sp (:func:`load_balancing_loss`);
  2. a stable sort of the (token, slot) assignments by destination rank,
     each packed into its destination's bucket ``[ep, C, H]`` (C is
     ``t_loc·k`` when dropless, else ``ceil8(cf·t_loc·k/ep)``; what does not
     fit is dropped), and the all-to-all of the buckets and of the local
     expert ids;
  3. the received rows through the local experts with the grouped GEMMs
     (K4–K6 on the card): empty slots are zeroed and given to expert
     ``e_loc - 1`` (``:81-84``), so that expert's group holds them;
  4. the reverse all-to-all and the weighted combine into each source
     token, plus the shared experts outside.

The combine writes each kept assignment to its (token, slot) place and sums
the k slots, as the single-device path does, so no index is added to twice.
Expert gradients are not reduced over ``ep``: each rank owns other experts
(the train step sums them over the axes they are replicated on).
``dropped_frac`` is the mean over the mesh.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from veomni_tpu_torch.parallel.functional import all_reduce_sum, all_to_all
from veomni_tpu_torch.parallel.parallel_state import AXIS_EP, ParallelState


def capacity(cfg, t_loc: int, ep: int) -> int:
    """Rows a source rank may send one destination (``:132-137``)."""
    k = cfg.num_experts_per_tok
    if cfg.moe_capacity_factor and cfg.moe_capacity_factor > 0:
        c = max(1, int(cfg.moe_capacity_factor * t_loc * k / ep))
        return -(-c // 8) * 8
    return t_loc * k  # dropless


def load_balancing_loss(probs, topk_idx, num_experts: int, pstate: ParallelState):
    """The switch loss over every token of the mesh (the reference computes
    it on the global arrays, ``:117-122``): each rank's per-expert dispatch
    counts, probability sums and token count are summed over dp×sp with a
    gradient, so every rank holds the same loss and each rank's router
    receives the gradient of every rank's loss term."""
    t, k = topk_idx.shape
    dispatch = F.one_hot(topk_idx.long(), num_experts).float().sum((0, 1))
    counts = torch.cat([dispatch, torch.tensor([float(t)], device=probs.device)])
    counts = all_reduce_sum(counts, pstate.group(pstate.dp_sp_axes))
    prob_sum = all_reduce_sum(probs.float().sum(0), pstate.group(pstate.dp_sp_axes))
    total = counts[-1]
    frac = counts[:-1] / (total * k)
    return num_experts * (frac * (prob_sum / total)).sum()


def _local_counts(ids, n: int):
    counts = torch.zeros(n, dtype=torch.int64, device=ids.device)
    return counts.scatter_add_(0, ids, torch.ones_like(ids))


def ep_moe_mlp(x, topk_idx, topk_w, experts, cfg, pstate: ParallelState):
    """Expert-parallel routed experts of x [T, H] (this rank's tokens) given
    the routing (topk_idx [T, K] global expert ids, topk_w [T, K]) and
    ``experts`` holding this rank's ``E/ep`` experts at full width ->
    (out [T, H], dropped_frac)."""
    from veomni_tpu_torch.models.transformer import experts_apply_sorted

    t, h = x.shape
    k = cfg.num_experts_per_tok
    ep = pstate.ep_size
    e_loc = cfg.num_experts // ep
    group = pstate.group((AXIS_EP,))
    cap = capacity(cfg, t, ep)

    flat_e = topk_idx.reshape(-1)
    dest = torch.div(flat_e, e_loc, rounding_mode="floor")
    order = torch.argsort(dest, stable=True)  # assignments grouped by destination
    dest_s = dest[order]
    start = torch.cumsum(_local_counts(dest_s, ep), 0) - _local_counts(dest_s, ep)
    slot = torch.arange(t * k, device=x.device) - start[dest_s]
    keep = slot < cap
    dropped = 1.0 - keep.float().mean()

    kept = order[keep]                        # flat (token, slot) index of kept ones
    bucket = (dest_s * cap + slot)[keep]      # their place in the send buffer
    send_x = torch.zeros(ep * cap, h, dtype=x.dtype, device=x.device).index_copy(
        0, bucket, x[torch.div(kept, k, rounding_mode="floor")])
    send_le = torch.full((ep * cap,), -1, dtype=torch.int64, device=x.device)
    send_le[bucket] = (flat_e % e_loc)[kept]
    recv_x = all_to_all(send_x.view(ep, cap, h), group, 0, 0).reshape(ep * cap, h)
    recv_le = all_to_all(send_le.view(ep, cap), group, 0, 0).reshape(ep * cap)

    valid = recv_le >= 0
    rle = torch.where(valid, recv_le, torch.full_like(recv_le, e_loc - 1))
    rx = torch.where(valid[:, None], recv_x, torch.zeros_like(recv_x))
    sort_idx = torch.argsort(rle, stable=True)
    group_sizes = _local_counts(rle, e_loc)
    out_s = experts_apply_sorted(rx[sort_idx], experts, group_sizes, cfg, rle[sort_idx])
    inverse = torch.empty_like(sort_idx)
    inverse[sort_idx] = torch.arange(sort_idx.numel(), device=x.device)
    back = all_to_all(out_s[inverse].view(ep, cap, h), group, 0, 0).reshape(ep * cap, h)

    weighted = back[bucket] * topk_w.reshape(-1).to(x.dtype)[kept][:, None]
    per_slot = torch.zeros(t * k, h, dtype=x.dtype, device=x.device).index_copy(
        0, kept, weighted)
    return per_slot.view(t, k, h).sum(1), dropped


def mesh_mean(value: torch.Tensor, pstate: Optional[ParallelState]) -> torch.Tensor:
    """Mean of a per-rank scalar over dp×sp (tp and pp ranks repeat it)."""
    if pstate is None:
        return value
    group = pstate.group(pstate.dp_sp_axes)
    if group is None:
        return value
    return all_reduce_sum(value.detach().float(), group) / pstate.axis_size(pstate.dp_sp_axes)
