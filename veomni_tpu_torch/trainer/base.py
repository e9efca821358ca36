"""BaseTrainer: builds the training stack and runs the loop.

Port of ``veomni_tpu/trainer/base.py`` at world size 1: the build sequence
of ``__init__`` (``:92-103``: setup -> model -> data transform -> dataset
-> dataloader -> train state -> callbacks), ``try_resume`` and
``apply_restored_extra`` (``:503-549``), the supervisor's rollback
(``:741``) and the loop of ``train()`` (``:793``) with its spans,
flight-recorder events, anomaly supervisor, watchdog and graceful
shutdown. The model is the port's ``Transformer`` and the step the port's
eager ``build_train_step``, which update the model and its AdamW in place.

The device is the card unless ``train.platform`` is ``cpu``, the caller's
explicit request (``utils/device.py::resolve_device`` raises when no card
is present). Host syncs follow the reference: metrics are fetched only on
log steps (``ctl.synced``); in between, callbacks see device tensors.
(With ``resilience_skip_nonfinite``, the port's step itself reads its
finite flag on the host once per step before the optimizer update.)

A model comes from ``model.config_overrides`` or from an HF directory
(``model.config_path``, ``model.model_path``: ``models/hf_io.py``, loaded
onto the run's device), and leaves as an HF export at train end
(``train.save_hf_weights``). The data path takes ``data.dyn_bsz``
(``data/dynamic_batching.py``), ``train.prefetch_depth``
(``data/prefetch.py``, closed on SIGTERM and before a rollback) and
``dataset_type: streaming`` (``data/streaming.py``), and ``conversation``
data through an HF tokenizer directory (``models/auto.py::build_tokenizer``,
``data/tokenizer.py``) and chat templates. ``model.lora`` trains adapters
over the frozen base (``lora/lora.py``: the train state's model is the
adapters, the base is ``base_model``), and ``model.freeze_modules`` /
``train.module_lr_scales`` group the optimizer
(``optim/optimizer.py::with_param_groups``) and mask frozen gradients
before the clip. Features whose modules are not ported yet raise
``NotImplementedError`` from one gate, :func:`check_supported`, naming the
knob and the queue item of ``ROADMAP.md`` that ports it.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from veomni_tpu_torch.arguments import VeOmniArguments
from veomni_tpu_torch.checkpoint import build_checkpointer
from veomni_tpu_torch.data.data_collator import TextPackingCollator
from veomni_tpu_torch.data.data_loader import build_dataloader
from veomni_tpu_torch.data.data_transform import build_data_transform
from veomni_tpu_torch.data.dataset import build_dataset
from veomni_tpu_torch.lora import (
    LoraAdapters,
    LoraConfig,
    apply_lora_to_loss_fn,
    init_lora_params,
    load_adapter,
)
from veomni_tpu_torch.models.auto import build_config, build_foundation_model, build_tokenizer
from veomni_tpu_torch.models.jax_weights import named_jax_parameters
from veomni_tpu_torch.observability.flight_recorder import (
    configure_flight_recorder,
    dump_postmortem,
    record as flight_record,
)
from veomni_tpu_torch.observability.spans import span
from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
from veomni_tpu_torch.optim.optimizer import with_param_groups
from veomni_tpu_torch.parallel import init_parallel_state, use_parallel_state
from veomni_tpu_torch.train import build_train_state, build_train_step
from veomni_tpu_torch.trainer.callbacks import (
    CheckpointCallback,
    EnvironMeterCallback,
    HFCheckpointCallback,
    LoggingCallback,
    ProfileCallback,
    TrainerControlState,
)
from veomni_tpu_torch.utils.count_flops import FlopsCounter
from veomni_tpu_torch.utils.device import resolve_device
from veomni_tpu_torch.utils.helper import EnvironMeter, live_memory_stats, set_seed
from veomni_tpu_torch.utils.logging import _process_index, get_logger

logger = get_logger(__name__)

BATCH_KEYS = ("input_ids", "labels", "position_ids", "segment_ids")
# the data transforms the port has (the multimodal ones are slice F)
SUPPORTED_DATA_TYPES = ("pretokenized", "plaintext", "conversation")


def check_supported(args: VeOmniArguments) -> None:
    """Raise ``NotImplementedError`` naming every configured knob whose
    module is not ported yet (the trainer's counterpart of
    ``models/transformer.py::check_supported``)."""
    m, d, t = args.model, args.data, args.train
    metrics_port = os.environ.get("VEOMNI_METRICS_PORT", "")
    missing = [f"{knob} ({why})" for knob, why, on in (
        (f"train.optimizer {t.optimizer!r}", "only adamw is ported; optim/muon.py: slice F",
         t.optimizer != "adamw"),
        (f"data.data_type {d.data_type!r}", "the multimodal transforms: slice F",
         d.data_type not in SUPPORTED_DATA_TYPES),
        ("data.eval_path", "EvaluateCallback and the eval loop: queue 1", bool(d.eval_path)),
        ("data.channel_list", "train/channel_loss.py: queue 1", bool(d.channel_list)),
        ("train.use_wandb", "WandbCallback: queue 1", t.use_wandb),
        ("train.observability_numerics_interval", "observability/numerics.py: slice E",
         t.observability_numerics_interval > 0),
        ("train.observability_port / VEOMNI_METRICS_PORT",
         "observability/exporter.py: slice E", bool(t.observability_port) or bool(metrics_port)),
        ("train.num_virtual_devices", "virtual devices are a JAX CPU-mesh feature; the "
         "multi-process mesh is slice C", t.num_virtual_devices > 0),
        ("train.ulysses_async", "parallel/async_ulysses.py: slice C", t.ulysses_async),
    ) if on]
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))


def resolve_platform(platform: str) -> torch.device:
    """``train.platform`` -> the run's device: ``cpu`` is the caller's
    explicit request for the CPU; empty, ``cuda`` or ``gpu`` is the card."""
    if platform == "cpu":
        return resolve_device("cpu")
    if platform in ("", "cuda", "gpu"):
        return resolve_device("cuda")
    raise ValueError(f"train.platform {platform!r}: the port runs on 'cuda' (default) or 'cpu'")


def maybe_initialize_distributed() -> None:
    """The reference joins a cluster here when the launcher's environment
    says so (``:57``). The port runs at world size 1, so an environment
    that asks for more than one process raises instead of training on a
    slice of the data."""
    asks = {k: os.environ[k] for k in ("WORLD_SIZE", "VEOMNI_NUM_PROCESSES")
            if os.environ.get(k, "1") not in ("", "1")}
    if os.environ.get("VEOMNI_AUTO_DISTRIBUTED") == "1":
        asks["VEOMNI_AUTO_DISTRIBUTED"] = "1"
    if asks:
        raise NotImplementedError(
            f"launcher environment {asks} asks for several processes: the port runs at "
            "world size 1; multi-process training is slice C of the port")


class _HostValue:
    """A device scalar the supervisor may read later: ``np.asarray`` of it
    fetches (the role of a JAX array future in the reference)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __array__(self, dtype=None, copy=None):
        v = self.value
        arr = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        return arr.astype(dtype) if dtype is not None else arr


class BaseTrainer:
    def __init__(self, args: VeOmniArguments):
        self.args = args
        self.current_batch: Optional[Dict[str, np.ndarray]] = None
        self.meter: Optional[EnvironMeter] = None
        check_supported(args)
        self._setup()
        with use_parallel_state(self.parallel_state):
            self._build_model()
            self._build_data_transform()
            self._build_dataset()
            self._build_dataloader()
            self._build_parallelized_state()
            self._init_callbacks()

    # ------------------------------------------------------------------ setup
    def _setup(self):
        t = self.args.train
        self.device = resolve_platform(t.platform)
        maybe_initialize_distributed()
        if t.enable_full_determinism:
            from veomni_tpu_torch.utils.determinism import enable_full_determinism

            self.generator = enable_full_determinism(t.seed, self.device)
        else:
            self.generator = set_seed(t.seed, self.device)
        dp_replicate = t.data_parallel_replicate_size
        dp_shard = t.data_parallel_shard_size
        if t.data_parallel_mode == "ddp":
            dp_replicate, dp_shard = -1, 1
        elif dp_replicate < 1:
            dp_replicate = 1
        self.parallel_state = init_parallel_state(
            dp_replicate_size=dp_replicate,
            dp_shard_size=dp_shard,
            ep_size=t.expert_parallel_size,
            ulysses_size=t.ulysses_parallel_size,
            cp_size=t.context_parallel_size,
            tp_size=t.tensor_parallel_size,
            pp_size=t.pipeline_parallel_size,
        )
        os.makedirs(t.output_dir, exist_ok=True)
        if _process_index() == 0:
            from veomni_tpu_torch.arguments import save_args

            save_args(self.args, t.output_dir)

    def _build_model(self):
        m = self.args.model
        overrides = dict(m.config_overrides)
        overrides.setdefault("dtype", self.args.train.compute_dtype)
        overrides.setdefault("param_dtype", self.args.train.param_dtype)
        overrides["remat"] = self.args.train.enable_gradient_checkpointing
        overrides.setdefault("remat_policy", self.args.train.gradient_checkpointing_policy)
        if self.args.train.chunk_mbs:
            overrides.setdefault("chunk_mbs", self.args.train.chunk_mbs)
        if m.model_type:
            overrides["model_type"] = m.model_type
        ops_pins = dict(m.ops_implementation)
        if m.attn_implementation not in ("auto", ""):
            ops_pins["attention"] = m.attn_implementation
        if m.moe_implementation not in ("auto", ""):
            ops_pins["group_gemm"] = m.moe_implementation
        if m.config_path:  # config.json, with the overrides on top
            self.model = build_foundation_model(
                m.config_path, ops_implementation=ops_pins, **overrides)
        else:
            self.model = build_foundation_model(
                None,
                config=build_config(overrides.get("model_type", ""), **{
                    k: v for k, v in overrides.items() if k != "model_type"}),
                ops_implementation=ops_pins,
            )
        # pretokenized data needs no tokenizer; don't fail on weights-only dirs
        self.tokenizer = None
        if m.tokenizer_path and self.args.data.data_type != "pretokenized":
            self.tokenizer = build_tokenizer(m.tokenizer_path)

    def _build_data_transform(self):
        d = self.args.data
        self.data_transform = build_data_transform(
            d.data_type, tokenizer=self.tokenizer,
            text_keys=d.text_keys, max_seq_len=d.max_seq_len,
            channel_list=d.channel_list, chat_template=d.chat_template,
        )

    def _build_dataset(self):
        d = self.args.data
        kwargs = {}
        if d.dataset_type == "streaming":
            # poison-record skip budget (resilience/integrity.py), replayed
            # bit-exactly across resume through the cursor state
            kwargs["skip_budget"] = self.args.train.data_skip_budget
        self.dataset = build_dataset(
            d.dataset_type, path=d.train_path, transform=self.data_transform, **kwargs,
        )

    def _build_dataloader(self):
        t, d = self.args.train, self.args.data
        ps = self.parallel_state
        self.grad_accum_steps = self.args.compute_grad_accum(ps.dp_size)
        local_mb = t.micro_batch_size * ps.dp_size
        collator = TextPackingCollator(
            seq_len=d.max_seq_len,
            micro_batch_size=local_mb,
            sp_size=ps.sp_size,
        )
        if d.dyn_bsz:
            from veomni_tpu_torch.data.dynamic_batching import DynamicBatchDataloader

            self.dataloader = DynamicBatchDataloader(
                self.dataset,
                collator,
                token_budget=local_mb * d.max_seq_len,
                grad_accum_steps=self.grad_accum_steps,
                buffer_size=d.dyn_bsz_buffer_size,
                seed=t.seed,
                dp_rank=0,
                dp_size=1,
            )
        else:
            self.dataloader = build_dataloader(
                d.dataloader_type,
                dataset=self.dataset,
                collate_fn=collator,
                micro_batch_size=local_mb,
                grad_accum_steps=self.grad_accum_steps,
                samples_per_micro_batch=max(1, d.samples_per_micro_batch * local_mb),
                seed=t.seed,
                dp_rank=0,
                dp_size=1,
                drop_last=d.drop_last,
                infinite=True,
            )

    def _build_parallelized_state(self):
        """Schedule, model init on the run's device, AdamW, train state,
        train step, meter and checkpointer (the reference's ``:283``
        without sharding: the state lives whole on one device)."""
        t = self.args.train
        steps = t.train_steps or max(1, len(self.dataloader) * t.num_train_epochs)
        self.train_steps = steps
        self.lr_schedule = build_lr_scheduler(
            t.lr_decay_style, lr=t.lr, train_steps=steps,
            lr_warmup_ratio=t.lr_warmup_ratio, lr_min=t.lr_min,
        )
        m = self.args.model
        if m.model_path:
            # train.broadcast_weights_from_rank0 is a no-op at world size 1:
            # the one process reads every tensor itself
            module = self.model.load_hf(m.model_path, device=self.device)
        else:
            module = self.model.init(self.generator, device=self.device)
        self.lora_config = LoraConfig.from_dict(m.lora)
        if self.lora_config is not None:
            # frozen base + trainable adapters (reference :312-373)
            self.base_model = module
            trainable = init_lora_params(self.generator, module, self.lora_config)
            if m.lora_adapter_path:
                load_adapter(m.lora_adapter_path, trainable)
            loss_fn = apply_lora_to_loss_fn(self.model.loss_fn, module)
        else:
            self.base_model = None
            trainable = module
            loss_fn = self.model.loss_fn
        self.optimizer = build_optimizer(
            trainable, lr=self.lr_schedule, betas=tuple(t.betas), weight_decay=t.weight_decay,
        )
        named = named_jax_parameters(trainable)
        if m.freeze_modules or t.module_lr_scales:
            self.optimizer = with_param_groups(
                self.optimizer, named, freeze_patterns=tuple(m.freeze_modules),
                lr_scales=dict(t.module_lr_scales))
        # frozen modules' grads are zeroed before the clip (reference :398-410)
        self.grad_mask = [p for path, p in named
                          if any(re.search(pat, path) for pat in m.freeze_modules)]
        self.train_state = build_train_state(trainable, self.optimizer)
        self.train_step = build_train_step(
            loss_fn, max_grad_norm=t.max_grad_norm, grad_mask=self.grad_mask or None,
            scope=LoraAdapters.merged if self.base_model is not None else None,
            skip_nonfinite=t.resilience_skip_nonfinite,
        )
        self._loss_fn = loss_fn
        self.meter = EnvironMeter(
            flops_counter=FlopsCounter.from_config(self.model.config),
            world_size=self.parallel_state.world_size,
            device=self.device,
        )
        self.checkpointer = build_checkpointer(
            t.load_checkpoint_path or os.path.join(t.output_dir, "checkpoints"),
            ckpt_manager=t.ckpt_manager,
            async_save=t.async_save,
            max_to_keep=t.max_ckpt_to_keep,
            io_retries=t.resilience_io_retries,
            retry_base_s=t.resilience_retry_base_s,
            verify_mode=t.ckpt_verify,
            elastic=t.ckpt_elastic,
        )

    def _init_callbacks(self):
        from veomni_tpu_torch.observability.callback import ObservabilityCallback

        t = self.args.train
        self.callbacks = [
            EnvironMeterCallback(self.meter),
            # after the meter (its rollup must be in the published payload),
            # before Logging (it consumes the registry export)
            ObservabilityCallback(),
            LoggingCallback(),
            CheckpointCallback(self.checkpointer, t.save_steps),
        ]
        if t.enable_profiling:
            self.callbacks.append(
                ProfileCallback(t.output_dir, t.profile_start_step, t.profile_end_step)
            )
        if t.save_hf_weights:
            self.callbacks.append(HFCheckpointCallback())

    # ----------------------------------------------------------------- resume
    def try_resume(self, step: Optional[int] = None,
                   max_step: Optional[int] = None):
        """``step=None`` walks back from the latest committed-and-verified
        checkpoint (generations failing manifest verification are
        quarantined and skipped); ``max_step`` caps the walk (supervisor
        rollback targets checkpoints from BEFORE the anomalous window); an
        explicit ``step`` pins the restore with no fallback. The restore
        lands in the live model and optimizer in place (moments and
        ``num_updates`` included)."""
        restored, extra = self.checkpointer.load(
            self.train_state, step=step, max_step=max_step,
        )
        if restored is not None:
            logger.info_rank0("resumed from checkpoint")
        return restored is not None, extra

    def apply_restored_extra(self, state, extra: Dict[str, Any]) -> None:
        """Apply a checkpoint's extra_state (global step, epoch, rank-local
        dataloader cursor, meter, stateful callbacks) to the live run. Shared
        by auto-resume (CheckpointCallback.on_train_begin) and the anomaly
        supervisor's rollback path."""
        if not extra:
            return
        state.global_step = int(extra.get("global_step", 0))
        state.epoch = int(extra.get("epoch", 0))
        if extra.get("dataloader") and hasattr(self.dataloader, "load_state_dict"):
            self.dataloader.load_state_dict(extra["dataloader"])
        if extra.get("meter") and self.meter:
            self.meter.load_state_dict(extra["meter"])
        for cb in self.callbacks:
            cb_state = extra.get("callbacks", {}).get(type(cb).__name__)
            if cb_state and hasattr(cb, "load_state_dict"):
                cb.load_state_dict(cb_state)

    def _ship_batch(self, batch_np):
        """Host batch -> device tensors: numpy -> pinned host tensor ->
        asynchronous copy to the card (plain tensors on the CPU)."""
        out = {}
        for k in BATCH_KEYS:
            t = torch.from_numpy(batch_np[k])
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # ------------------------------------------------------------------ train
    def _fire(self, hook: str, state):
        for cb in self.callbacks:
            getattr(cb, hook)(self, state)

    def _start_data_iter(self):
        """(Re)build the prefetcher and the iterator: at train start and after
        a supervisor rollback restored the dataloader cursor (the prefetch
        thread starts pulling at construction, so the cursor must already be
        in place)."""
        t = self.args.train
        self._prefetcher = None
        if t.prefetch_depth > 0:
            from veomni_tpu_torch.data.prefetch import BackgroundPrefetcher

            self._prefetcher = BackgroundPrefetcher(self.dataloader, depth=t.prefetch_depth)
        return iter(self._prefetcher or self.dataloader)

    def _close_prefetcher(self):
        """Idempotent; also invoked from the SIGTERM handler to wake a
        consumer blocked on the prefetch queue."""
        pf = getattr(self, "_prefetcher", None)
        if pf is not None:
            pf.close()

    def _close_callbacks(self):
        """Exception-safe teardown for resource-holding callbacks (an
        active profiler trace) — runs on both the loop's exit paths and a
        startup failure in ``on_train_begin``."""
        for cb in self.callbacks:
            try:
                cb.close()
            except Exception as e:
                logger.warning_rank0(
                    "callback %s close() failed: %s",
                    type(cb).__name__, e,
                )

    @staticmethod
    def _postmortem_extra(e: BaseException, global_step: int) -> Dict[str, Any]:
        """Post-mortem payload for an exception escaping train(); a card
        out-of-memory error also carries the memory gauges. Never raises."""
        extra: Dict[str, Any] = {"error": str(e)[:2000],
                                 "global_step": global_step}
        if isinstance(e, torch.cuda.OutOfMemoryError):
            try:
                extra["memory"] = live_memory_stats()
            except Exception as forensic_err:
                extra["oom_report_error"] = str(forensic_err)
        return extra

    def _poison_param(self, pattern: str) -> str:
        """The ``step.params`` fault drill (reference
        ``observability/numerics.py::poison_param_group``): set ONE element
        of the first float parameter whose name contains ``pattern`` (in
        sorted-name order; empty = the first) to NaN. Returns its name, or
        "" when none matches."""
        for name, p in sorted(self.train_state.model.named_parameters()):
            if (not pattern or pattern in name) and p.is_floating_point():
                with torch.no_grad():
                    p.view(-1)[0] = float("nan")
                return name
        return ""

    def _rollback(self, ctl, sup):
        """Supervisor escalation: restore the latest committed checkpoint
        before the anomalous run (params + optimizer + rank-local data
        cursor) and replay the iterator from there. Returns the fresh data
        iterator."""
        from veomni_tpu_torch.resilience.supervisor import RollbackImpossible

        logger.warning_rank0(
            "anomaly escalation: rolling back from step %d to the latest "
            "committed checkpoint", ctl.global_step,
        )
        self._close_prefetcher()
        try:
            self.checkpointer.wait()  # an in-flight save may be the target
        except Exception as e:
            logger.warning_rank0("in-flight save failed during rollback: %s", e)
        max_step = None
        first_bad = sup.consec_start
        committed = self.checkpointer.list_steps()
        if first_bad is not None:
            before = [s for s in committed if s < first_bad]
            if before:
                max_step = before[-1]
            elif committed:
                logger.warning_rank0(
                    "no committed checkpoint precedes anomalous step %d; "
                    "restoring the latest (cursor will NOT re-run the "
                    "anomalous batches)", first_bad,
                )
        restored, extra = self.try_resume(max_step=max_step)
        if not restored:
            raise RollbackImpossible(
                "rollback requested but no committed checkpoint exists "
                "(set train.save_steps to create mid-run rollback targets)"
            )
        self.apply_restored_extra(ctl, extra)
        sup.note_rollback(to_step=ctl.global_step)
        return self._start_data_iter()

    def _fetch(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """Device metrics -> host floats (scalars) and arrays."""
        out = {}
        for k, v in metrics.items():
            if torch.is_tensor(v):
                v = v.detach().cpu()
                out[k] = float(v) if v.ndim == 0 else v.numpy()
            else:
                out[k] = float(v) if np.ndim(v) == 0 else np.asarray(v)
        return out

    def train(self):
        t = self.args.train
        from veomni_tpu_torch.resilience import (
            GracefulShutdown,
            SupervisorPolicy,
            TrainSupervisor,
        )
        from veomni_tpu_torch.resilience.faults import arm_from_env, fault_point
        from veomni_tpu_torch.resilience.supervisor import AnomalyBudgetExceeded, worse_verdict
        from veomni_tpu_torch.utils.helper import Watchdog

        arm_from_env()  # VEOMNI_FAULT_PLAN (tests/chaos drills); no-op else
        # dump-dir wiring BEFORE any callback can raise
        configure_flight_recorder(
            max_events=t.observability_flight_events, dump_dir=t.output_dir,
            fresh=True,
        )
        ctl = TrainerControlState(train_steps=self.train_steps)
        sup = TrainSupervisor(SupervisorPolicy.from_train_args(t))
        self._supervisor = sup
        with use_parallel_state(self.parallel_state):
            try:
                self._fire("on_train_begin", ctl)
                flight_record("train.begin", cid=str(ctl.global_step),
                              train_steps=self.train_steps)
                # after on_train_begin: auto-resume restores the cursor there,
                # and the prefetch thread starts pulling at construction
                data_iter = self._start_data_iter()
            except BaseException as e:
                dump_postmortem(
                    f"exception:{type(e).__name__}",
                    extra=self._postmortem_extra(e, ctl.global_step),
                )
                self._close_prefetcher()
                self._close_callbacks()
                raise
            # SIGTERM = cluster preemption notice: finish the current step,
            # take one final synchronous checkpoint, return (exit 0) so the
            # restarted job resumes bit-exactly
            shutdown = GracefulShutdown(on_request=self._close_prefetcher)
            watchdog = Watchdog(
                t.resilience_watchdog_s, on_stall=sup.note_stall,
                description="train loop",
            )
            try:
                with shutdown, watchdog:
                    while True:
                        while ctl.global_step < self.train_steps and not ctl.should_stop:
                            if shutdown.requested:
                                break
                            try:
                                with span("data.wait"):
                                    batch_np = next(data_iter)
                            except Exception:
                                if shutdown.requested:
                                    break  # prefetcher closed by the handler
                                raise
                            self.current_batch = batch_np
                            fault_point("step.delay")
                            act = fault_point("step.params")
                            if act is not None and act.mode == "nan":
                                target = self._poison_param(act.target)
                                logger.warning_rank0(
                                    "fault step.params poisoned %s", repr(target) if target
                                    else f"NOTHING: no float parameter matches {act.target!r}")
                            with span("host.callbacks"):
                                self._fire("on_step_begin", ctl)
                            with span("data.ship"):
                                batch = self._ship_batch(batch_np)
                            # dispatch is recorded BEFORE the step and end
                            # AFTER the callbacks, so a post-mortem of a hang
                            # shows the wedged step as dispatched-never-ended
                            flight_record("step.dispatch",
                                          cid=str(ctl.global_step + 1))
                            with span("step.dispatch"):
                                self.train_state, metrics = self.train_step(
                                    self.train_state, batch
                                )
                            ctl.global_step += 1
                            verdict = sup.observe(ctl.global_step, {
                                "loss": _HostValue(metrics["loss"]),
                                "step_ok": _HostValue(metrics["step_ok"]),
                            })
                            if sup.last_injected:
                                metrics = dict(metrics)
                                metrics["step_ok"] = False
                            watchdog.pet()
                            # fetch only on log steps: in between, callbacks
                            # receive device tensors and the host runs ahead
                            ctl.synced = (
                                ctl.global_step % t.log_steps == 0
                                or ctl.global_step >= self.train_steps
                            )
                            if ctl.synced:
                                with span("sync.fetch"):
                                    metrics = self._fetch(metrics)
                            ctl.metrics = dict(metrics)
                            if ctl.synced:
                                # the schedule's value for the update just
                                # applied (update count step - 1)
                                ctl.metrics["lr"] = float(
                                    self.lr_schedule(ctl.global_step - 1)
                                )
                                if verdict in ("ok", "skip"):
                                    verdict = worse_verdict(verdict, sup.drain())
                                ctl.resilience = sup.stats()
                            with span("host.callbacks"):
                                self._fire("on_step_end", ctl)
                            flight_record("step.end", cid=str(ctl.global_step),
                                          synced=ctl.synced)
                            if verdict == "rollback":
                                data_iter = self._rollback(ctl, sup)
                            elif verdict == "abort":
                                raise AnomalyBudgetExceeded(
                                    f"anomaly budget exceeded at step "
                                    f"{ctl.global_step}: {sup.stats()}"
                                )
                        if shutdown.requested and ctl.global_step < self.train_steps:
                            ctl.preempted = True
                            ctl.should_stop = True
                            sup.drain()
                            logger.warning_rank0(
                                "preemption stop at step %d: taking the final "
                                "checkpoint, then exiting cleanly",
                                ctl.global_step,
                            )
                            flight_record("shutdown.request",
                                          cid=str(ctl.global_step),
                                          signum=shutdown.signum)
                            dump_postmortem(
                                "sigterm",
                                extra={"global_step": ctl.global_step},
                            )
                            break
                        if ctl.should_stop:
                            sup.drain()
                            break
                        # step budget exhausted, but queued verdicts remain
                        verdict = sup.drain()
                        if verdict == "abort":
                            raise AnomalyBudgetExceeded(
                                f"anomaly budget exceeded in the final steps: "
                                f"{sup.stats()}"
                            )
                        if verdict == "rollback":
                            data_iter = self._rollback(ctl, sup)
                            continue  # re-run the rolled-back steps
                        break
                    # still inside the signal scope: the final synchronous
                    # checkpoint must not die to a repeated SIGTERM
                    ctl.resilience = sup.stats()
                    self._fire("on_train_end", ctl)
                    flight_record("train.end", cid=str(ctl.global_step))
            except BaseException as e:
                dump_postmortem(
                    f"exception:{type(e).__name__}",
                    extra=self._postmortem_extra(e, ctl.global_step),
                )
                raise
            finally:
                self._close_prefetcher()
                self._close_callbacks()
        return ctl
