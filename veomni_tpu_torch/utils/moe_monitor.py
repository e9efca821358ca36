"""MoE router monitoring: expert-load capture and an imbalance callback.

Port of ``veomni_tpu/utils/moe_monitor.py``. The reference replays an eager
forward layer by layer with a capture list that ``_moe_mlp`` appends its
top-k choices to (its jitted scan has no hooks). The port's forward is
eager already: :func:`capture_router_stats` runs the model's own
``forward_hidden`` under ``torch.no_grad`` inside :func:`capture_routing`,
which sets ``models/transformer.py::ROUTER_CAPTURE``, and counts each MoE
layer's choices on the device. The replay launches the attention forward
and the forward grouped GEMMs once per layer, nothing else. As in the
reference, the trainer never attaches :class:`MoERouterMonitorCallback`;
a caller appends it to ``trainer.callbacks``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from veomni_tpu_torch.models import transformer
from veomni_tpu_torch.trainer.callbacks import Callback
from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@contextlib.contextmanager
def capture_routing():
    captured: List[torch.Tensor] = []
    transformer.ROUTER_CAPTURE = captured
    try:
        yield captured
    finally:
        transformer.ROUTER_CAPTURE = None


def capture_router_stats(module, batch) -> Dict[str, np.ndarray]:
    """A ``no_grad`` forward of ``module`` (a MoE ``Transformer``) on
    ``batch`` -> ``{"expert_load": [L_moe, E]}``, each row a MoE layer's
    share of the top-k assignments per expert (rows sum to 1)."""
    e = module.cfg.num_experts
    with torch.no_grad(), capture_routing() as caps:
        module.forward_hidden(batch["input_ids"], batch["position_ids"],
                              batch.get("segment_ids"))
        counts = [transformer.expert_counts(topk.reshape(-1), e) for topk in caps]
    if not counts:
        return {"expert_load": np.zeros((0, e))}
    loads = torch.stack(counts).double().cpu().numpy()
    return {"expert_load": loads / np.maximum(loads.sum(1, keepdims=True), 1)}


def publish_router_stats(load: np.ndarray, registry=None) -> None:
    """Per-layer router health -> registry gauges (``moe.layer{i}.*``):
    ``entropy`` (nats; ln E is perfectly balanced), ``max_load`` (the
    hottest expert's share) and ``drop_frac`` (the load above each expert's
    fair share, what a capacity factor of 1.0 would drop; the dropless MoE
    drops nothing, so this is imbalance pressure, not lost tokens)."""
    from veomni_tpu_torch.observability.metrics import get_registry

    reg = registry or get_registry()
    for li, row in enumerate(np.asarray(load, np.float64)):
        nz = row[row > 0]
        reg.gauge(f"moe.layer{li}.entropy").set(
            float(-(nz * np.log(nz)).sum()) if len(nz) else 0.0)
        reg.gauge(f"moe.layer{li}.max_load").set(float(row.max()))
        reg.gauge(f"moe.layer{li}.drop_frac").set(
            float(np.clip(row - 1.0 / len(row), 0.0, None).sum()))


class MoERouterMonitorCallback(Callback):
    """Every ``every_steps`` steps, replays the routing of the step's first
    micro-batch, publishes the per-layer gauges and logs the load's range."""

    def __init__(self, every_steps: int = 100):
        self.every = every_steps

    def on_step_end(self, trainer, state):
        if not getattr(trainer.model.config, "is_moe", False) or state.global_step % self.every:
            return
        micro = {k: v[0] for k, v in trainer._ship_batch(trainer.current_batch).items()}
        adapters = trainer.train_state.model if trainer.base_model is not None else None
        with adapters.merged() if adapters is not None else contextlib.nullcontext():
            module = trainer.base_model if adapters is not None else trainer.train_state.model
            load = capture_router_stats(module, micro)["expert_load"]
        if len(load):
            publish_router_stats(load)
            logger.info_rank0(
                "moe router load: min=%.3f max=%.3f (ideal %.3f) worst layer %d",
                load.min(), load.max(), 1.0 / load.shape[1], int(load.max(1).argmax()))
