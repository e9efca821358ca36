"""Trainer callbacks: hooks + the stock set.

Port of ``veomni_tpu/trainer/callbacks.py``: ``TrainerControlState``, the
hook protocol, ``LoggingCallback``, ``EnvironMeterCallback``,
``EvaluateCallback`` (``:173``), ``CheckpointCallback`` (``:196``),
``HFCheckpointCallback`` (``:254``), ``ProfileCallback``, which drives
``torch.profiler`` where the reference drives ``jax.profiler``, and
``WandbCallback`` (``:330``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from veomni_tpu_torch.utils.helper import host_floats
from veomni_tpu_torch.utils.logging import _process_index, get_logger

logger = get_logger(__name__)


@dataclass
class TrainerControlState:
    """Mutable loop state shared with callbacks (reference TrainerState)."""

    global_step: int = 0
    train_steps: int = 0
    epoch: int = 0
    metrics: Dict[str, float] = field(default_factory=dict)
    should_stop: bool = False
    # True on steps where the loop materialized metrics to host floats (log
    # cadence + final step). On other steps metrics hold device tensors;
    # callbacks that read values must gate on this to keep the loop async.
    synced: bool = True
    # set when a SIGTERM/preemption request stopped the loop early (the
    # final checkpoint was still taken; the process should exit 0)
    preempted: bool = False
    # resilience supervisor rollup (anomalies, rollbacks, watchdog stalls)
    resilience: Dict[str, Any] = field(default_factory=dict)


class Callback:
    def on_train_begin(self, trainer, state: TrainerControlState):
        pass

    def on_train_end(self, trainer, state: TrainerControlState):
        pass

    def on_step_begin(self, trainer, state: TrainerControlState):
        pass

    def on_step_end(self, trainer, state: TrainerControlState):
        pass

    def close(self):
        """Exception-safe teardown: BaseTrainer calls this in its finally
        block, so resource holders (profiler trace) release even when the
        loop raises and ``on_train_end`` never fires. Must be idempotent."""
        pass


def _export_payload(state: TrainerControlState) -> Dict[str, Any]:
    """The metric payload consumers log: the observability registry's
    export for this step (ObservabilityCallback publishes before the
    logging callbacks run), falling back to ``state.metrics`` when the
    observability layer isn't in the callback list (trainer-free tests)."""
    from veomni_tpu_torch.observability.metrics import get_registry

    payload = get_registry().last_export(step=state.global_step)
    return payload if payload is not None else state.metrics


class LoggingCallback(Callback):
    """Console log on the loop's sync cadence (train.log_steps), fed from
    the observability registry's export (one merged payload: step metrics +
    goodput split + span/subsystem rollups)."""

    KEYS = ("loss", "grad_norm", "lr", "tokens_per_sec_per_chip", "mfu",
            "goodput_pct", "data_wait_frac")

    def on_step_end(self, trainer, state):
        if state.synced:
            payload = _export_payload(state)
            parts = [f"step {state.global_step}/{state.train_steps}"]
            for k in self.KEYS:
                if k in payload:
                    parts.append(f"{k}={payload[k]:.4g}")
            logger.info_rank0(" | ".join(parts))


class EnvironMeterCallback(Callback):
    """Feeds the MFU meter (reference EnvironMeterCallback): the text
    tokens, plus the qwen-vl vision tower's forward FLOPs on a VLM batch
    (``_tower_flops``, reference ``:119-166``); the DiT term belongs to the
    model families of slice F.

    With the async loop, per-step wall time measures dispatch, not compute —
    only the fetch at a sync step absorbs the real device time. The meter is
    therefore rolled up once per sync window (state.synced) so
    throughput/MFU are window averages over real elapsed time."""

    def __init__(self, meter):
        self.meter = meter

    def on_step_begin(self, trainer, state):
        batch = trainer.current_batch
        if batch is None:
            return
        labels = batch["labels"]
        self.meter.add(int((labels != -100).sum()), seq_len=labels.shape[-1],
                       extra_flops=self._tower_flops(trainer, batch))

    @staticmethod
    def _tower_flops(trainer, batch) -> float:
        """Promised forward FLOPs of the vision tower on a packed patch
        batch: the real patches (merge_unit a valid merged token), each
        attending over its window (Qwen2.5-VL's ``window_size`` in pixels,
        squared in patches) or, without one, over every patch of the batch,
        as the reference counts (``:119-166``)."""
        vision = getattr(getattr(trainer.model, "config", None), "vision", None)
        if vision is None or "vis_merged_mask" not in batch:
            return 0.0
        from veomni_tpu_torch.utils.count_flops import vit_flops_fwd

        patches = int(np.asarray(batch["vis_merged_mask"]).sum()) * vision.merge_unit
        if not patches:
            return 0.0
        window = getattr(vision, "window_size", 0)
        return vit_flops_fwd(vision, patches,
                             window_seq=(window // vision.patch_size) ** 2 if window else None)

    def on_step_end(self, trainer, state):
        if state.synced:
            state.metrics.update(self.meter.step())


class EvaluateCallback(Callback):
    """Every ``eval_steps`` steps, and at train end when the last step was
    not one of them, ``trainer.evaluate()``'s forward-only loss over
    ``data.eval_path`` lands in ``state.metrics["eval_loss"]`` (the
    reference's EvaluateCallback is an empty TODO; this one runs)."""

    def __init__(self, eval_steps: int):
        self.eval_steps = eval_steps

    def _run(self, trainer, state):
        loss = trainer.evaluate()
        if loss is not None:
            state.metrics["eval_loss"] = loss
            logger.info_rank0("step %d | eval_loss=%.4g", state.global_step, loss)

    def on_step_end(self, trainer, state):
        if self.eval_steps and state.global_step % self.eval_steps == 0:
            self._run(trainer, state)

    def on_train_end(self, trainer, state):
        if not self.eval_steps or state.global_step % self.eval_steps:
            self._run(trainer, state)


class CheckpointCallback(Callback):
    """Periodic train-state save + exact resume
    (reference CheckpointerCallback, checkpoint_callback.py:35-170)."""

    def __init__(self, checkpointer, save_steps: int = 0):
        self.checkpointer = checkpointer
        self.save_steps = save_steps

    def _extra_state(self, trainer, state) -> Dict[str, Any]:
        return {
            "global_step": state.global_step,
            "epoch": state.epoch,
            "meter": trainer.meter.state_dict() if trainer.meter else None,
            # any stateful callback rides along
            "callbacks": {
                type(cb).__name__: cb.state_dict()
                for cb in trainer.callbacks
                if hasattr(cb, "state_dict")
            },
        }

    def _rank_state(self, trainer) -> Dict[str, Any]:
        # rank-LOCAL: the dataloader cursor + packing carry-over buffer hold
        # this process's data shard; each rank saves/restores its own. With
        # background prefetch the thread runs ahead of the trainer, so the
        # cursor comes from the prefetcher (the last CONSUMED batch).
        src = getattr(trainer, "_prefetcher", None) or trainer.dataloader
        return {
            "dataloader": src.state_dict()
            if hasattr(src, "state_dict")
            else None,
        }

    def on_train_begin(self, trainer, state):
        if not trainer.args.train.auto_resume:
            return
        restored, extra = trainer.try_resume()
        if restored and extra:
            trainer.apply_restored_extra(state, extra)

    def on_step_end(self, trainer, state):
        if self.save_steps and state.global_step % self.save_steps == 0:
            self.checkpointer.save(
                state.global_step, trainer.train_state,
                self._extra_state(trainer, state),
                rank_state=self._rank_state(trainer),
            )

    def on_train_end(self, trainer, state):
        self.checkpointer.save(
            state.global_step, trainer.train_state,
            self._extra_state(trainer, state),
            rank_state=self._rank_state(trainer),
        )
        self.checkpointer.wait()


class HFCheckpointCallback(Callback):
    """HF-format safetensors export of the trained model to
    ``<output_dir>/hf_ckpt`` at the end of training (reference
    ``trainer/callbacks.py:254-272``). A LoRA run writes the adapter to
    ``<output_dir>/lora_adapter`` and the merged full model (``W + scale *
    A @ B``, merged one layer at a time as it is written) to ``hf_ckpt``."""

    def on_train_end(self, trainer, state):
        out_dir = trainer.args.train.output_dir
        module = trainer.train_state.model
        if getattr(trainer, "base_model", None) is None:
            trainer.model.save_hf(os.path.join(out_dir, "hf_ckpt"), module=module)
            return
        from veomni_tpu_torch.lora import save_adapter, save_merged_hf

        save_adapter(module, trainer.lora_config, os.path.join(out_dir, "lora_adapter"))
        save_merged_hf(trainer.base_model, module, os.path.join(out_dir, "hf_ckpt"))


class ProfileCallback(Callback):
    """``torch.profiler`` trace over [start_step, end_step): host ops and,
    on a card, CUDA kernels, written as a chrome trace
    ``<output_dir>/profile_trace/trace_rank<R>.json.gz`` (the reference
    writes a ``jax.profiler`` trace to the same directory).

    ``VEOMNI_PROFILE_START`` / ``VEOMNI_PROFILE_END`` override the
    configured window. Stop is exception-safe and idempotent: the trainer's
    finally block calls :meth:`close`, so a raise inside the traced window
    never leaks an active profiler."""

    def __init__(self, output_dir: str, start_step: int = 3, end_step: int = 5):
        self.dir = os.path.join(output_dir, "profile_trace")
        self.start = int(os.environ.get("VEOMNI_PROFILE_START", start_step))
        self.end = int(os.environ.get("VEOMNI_PROFILE_END", end_step))
        self._prof = None

    def _stop(self):
        if self._prof is None:
            return  # double-stop guard
        prof, self._prof = self._prof, None
        from veomni_tpu_torch.observability.spans import set_profiler_active

        set_profiler_active(False)
        try:
            prof.stop()
            path = os.path.join(self.dir, f"trace_rank{_process_index()}.json.gz")
            prof.export_chrome_trace(path)
        except Exception as e:
            # never let trace teardown mask the original failure
            logger.warning_rank0("profiler stop failed: %s", e)
            return
        logger.info_rank0("profile trace written to %s", path)

    def on_step_begin(self, trainer, state):
        if state.global_step == self.start and self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(self.dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            # host spans mirror into record_function ranges while it runs
            from veomni_tpu_torch.observability.spans import set_profiler_active

            set_profiler_active(True)

    def on_step_end(self, trainer, state):
        if state.global_step >= self.end:
            self._stop()

    def on_train_end(self, trainer, state):
        self._stop()

    def close(self):
        self._stop()


class WandbCallback(Callback):
    """Logs to Weights & Biases on the sync cadence, and on any step that
    put ``eval_loss`` into the metrics: the registry's export overlaid with
    ``state.metrics`` (callbacks after the export, the eval and channel
    losses, must not be dropped), host scalars only. ``wandb`` is imported
    here; where it is missing or ``wandb.init`` fails, the reason is logged
    once and the callback does nothing."""

    def __init__(self, project: str, name: str = "", config: Optional[dict] = None):
        self._run = None
        try:
            import wandb

            self._run = wandb.init(project=project, name=name or None, config=config)
        except Exception as e:  # not installed, or no network
            logger.warning_rank0("wandb disabled: %s", e)

    def on_step_end(self, trainer, state):
        if self._run is None:
            return
        if state.synced or "eval_loss" in state.metrics:
            payload = host_floats({**_export_payload(state), **state.metrics})
            if payload:
                self._run.log(payload, step=state.global_step)

    def on_train_end(self, trainer, state):
        if self._run is not None:
            # metrics of earlier on_train_end hooks (the final eval) land
            # after the last step's log
            payload = host_floats(state.metrics)
            if payload:
                self._run.log(payload, step=state.global_step)
            self._run.finish()
