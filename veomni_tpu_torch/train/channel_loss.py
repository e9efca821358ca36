"""Per-data-source ("channel") loss accounting.

Port of ``veomni_tpu/train/channel_loss.py``: the collator stamps each token
with its sample's channel id (``data/data_collator.py``,
``with_channels``); the loss fn returns per-channel (sum, count) vectors,
which the train step sums over the micro-batches as it does every vector
extra (``train/train_step.py``), and :class:`ChannelLossCallback`
accumulates them and logs each channel's token-mean loss. The per-channel
sums are ``index_add`` over the per-token NLL where the reference takes a
``segment_sum``; tokens that are ignored or carry no channel (-1) land in
an overflow slot that is dropped.

Text models take their final hidden states from ``forward_hidden``; a
vision-language composite (``models/qwen2_5_vl.py::VisionLanguageModel``)
from its ``merged_hidden``, the twin of the reference's
``_vision_merged_hidden`` preamble.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from veomni_tpu_torch import ops
from veomni_tpu_torch.trainer.callbacks import Callback
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

IGNORE_INDEX = -100


def _hidden(module, batch):
    """(the text Transformer holding the head, final hidden [B,S,H], router
    aux, labels, channel ids): a VLM composite takes whole rows and keeps
    its sequence chunk under sequence parallelism, so its labels and channel
    ids are cut to the same chunk."""
    if hasattr(module, "merged_hidden"):
        hidden, aux, labels = module.merged_hidden(batch)
        from veomni_tpu_torch.parallel.parallel_state import get_parallel_state_or_none
        from veomni_tpu_torch.parallel.sequence_parallel import sp_slice

        ps = get_parallel_state_or_none()
        ch = batch["channel_ids"]
        return (module.language_model, hidden, aux, labels,
                sp_slice(ch, ps) if ps is not None else ch)
    hidden, aux = module.forward_hidden(batch["input_ids"], batch["position_ids"],
                                        batch.get("segment_ids"))
    return module, hidden, aux, batch["labels"], batch["channel_ids"]


def make_channel_loss_fn(num_channels: int) -> Callable:
    """``loss_fn(module, batch)``: the model's token-sum loss (with the
    scaled router aux loss of a MoE), plus ``channel_loss_sums`` and
    ``channel_token_counts`` [num_channels] f32. ``batch`` carries
    ``channel_ids`` [B,S] (-1 on pad and unchanneled tokens)."""

    def loss_fn(module, batch):
        lm, hidden, moe_aux, labels, channel_ids = _hidden(module, batch)
        cfg = lm.cfg
        b, s, h = hidden.shape
        labels = labels.reshape(-1)
        nll = ops.fused_linear_cross_entropy_per_token(
            hidden.reshape(b * s, h), lm.lm_head_kernel().to(cfg.dtype), labels,
            logit_softcap=cfg.final_logit_softcap or None)
        valid = labels != IGNORE_INDEX
        ntokens = valid.sum()
        ch = channel_ids.reshape(-1).long()
        slot = torch.where(valid & (ch >= 0), ch, torch.full_like(ch, num_channels))
        sums = nll.new_zeros(num_channels + 1).index_add(0, slot, nll)[:-1]
        counts = nll.new_zeros(num_channels + 1).index_add(0, slot, valid.float())[:-1]
        total = nll.sum()
        if cfg.is_moe and cfg.router_aux_loss_coef:
            total = total + cfg.router_aux_loss_coef * moe_aux * ntokens
        return total, {"ntokens": ntokens, "channel_loss_sums": sums,
                       "channel_token_counts": counts}

    return loss_fn


class ChannelLossCallback(Callback):
    """Accumulates each channel's loss sum and token count and logs the
    token means every ``log_steps`` steps; its totals ride in the
    checkpoint's extra state (``state_dict``/``load_state_dict``)."""

    def __init__(self, channel_names: List[str], log_steps: int = 50):
        self.names = list(channel_names)
        self.log_steps = log_steps
        self._sums = [0.0] * len(self.names)
        self._counts = [0.0] * len(self.names)
        self._acc_sums = None  # on the device between folds
        self._acc_counts = None

    def _fold(self):
        """Fetch the device accumulators into the host totals (one sync)."""
        if self._acc_sums is None:
            return
        sums = self._acc_sums.cpu().tolist()
        counts = self._acc_counts.cpu().tolist()
        for i in range(len(self.names)):
            self._sums[i] += sums[i]
            self._counts[i] += counts[i]
        self._acc_sums = self._acc_counts = None

    def on_step_end(self, trainer, state):
        sums = state.metrics.pop("channel_loss_sums", None)
        counts = state.metrics.pop("channel_token_counts", None)
        if sums is None:
            return
        # a step that is not ok (non-finite loss or grad) left the model
        # untouched; its sums are dropped too, so one NaN cannot poison the
        # running means. The flag is a host value on synced steps (or False
        # after an injected drill), else a device tensor, masked lazily.
        ok = state.metrics.get("step_ok")
        if isinstance(ok, (bool, int, float)):
            if not ok:
                return
        elif ok is not None:
            sums = torch.where(ok, torch.as_tensor(sums), 0.0)
            counts = torch.where(ok, torch.as_tensor(counts), 0.0)
        # f64 accumulators: the totals do not depend on when they are folded
        # (a save folds them), so a resumed run ends with the same bits
        sums, counts = torch.as_tensor(sums).double(), torch.as_tensor(counts).double()
        self._acc_sums = sums if self._acc_sums is None else self._acc_sums + sums
        self._acc_counts = counts if self._acc_counts is None else self._acc_counts + counts
        if state.global_step % self.log_steps == 0:
            self._fold()
            logger.info_rank0("channel_loss | %s", " | ".join(
                f"{n}={self._sums[i] / max(self._counts[i], 1):.4f}({int(self._counts[i])}tok)"
                for i, n in enumerate(self.names)))

    def state_dict(self):
        self._fold()
        return {"sums": list(self._sums), "counts": list(self._counts)}

    def load_state_dict(self, state):
        self._sums = list(state.get("sums", self._sums))
        self._counts = list(state.get("counts", self._counts))
