"""BaseTrainer: builds the training stack and runs the loop.

Port of ``veomni_tpu/trainer/base.py``: the build sequence
of ``__init__`` (``:92-103``: setup -> model -> data transform -> dataset
-> dataloader -> train state -> callbacks), ``_inner_loss_fn``
(``:441-456``), ``try_resume`` and ``apply_restored_extra``
(``:503-549``), ``evaluate`` (``:549-620``), the supervisor's rollback
(``:741``) and the loop of ``train()`` (``:793``) with its spans,
flight-recorder events, anomaly supervisor, watchdog and graceful
shutdown. The model is the port's ``Transformer`` and the step the port's
eager ``build_train_step``, which update the model and its AdamW in place.

The device is the card unless ``train.platform`` is ``cpu``, the caller's
explicit request (``utils/device.py::resolve_device`` raises when no card
is present). Several processes (a launcher's ``RANK``/``WORLD_SIZE``/
``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT`` or the reference's
``VEOMNI_COORDINATOR_ADDRESS``/``VEOMNI_NUM_PROCESSES``/``VEOMNI_PROCESS_ID``)
join one process group (:func:`maybe_initialize_distributed`); the mesh is
``parallel/parallel_state.py``'s, each rank loads its dp slice of the data
and its sp chunk of each row, the model is laid out by
``parallel/parallel_plan.py`` and the step reduces over the mesh
(``train/train_step.py``). Only rank 0 logs and writes the checkpoint's
payload and the exports. Host syncs follow the reference: metrics are
fetched only on log steps (``ctl.synced``); in between, callbacks see
device tensors.
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
before the clip. ``data.eval_path`` adds the eval loop
(``EvaluateCallback``), ``data.channel_list`` the per-channel loss
(``train/channel_loss.py``) and ``train.use_wandb`` the W&B log; the
post-training trainers (``trainer/{dpo,distill,rl}_trainer.py``) override
the loss fn and the data path. ``train.optimizer`` takes every optimizer of
``optim/optimizer.py::build_optimizer``; ``train.observability_numerics_interval``
runs the numerics observatory's instrumented step every N-th step and
attributes an anomalous step (``_diagnose_numerics``); the train, numerics
and eval steps are cost-census sites (``observability/cost.py``); an
out-of-memory error's post-mortem holds the buffer census
(``observability/devmem.py``). Features whose modules are not ported yet raise
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
from veomni_tpu_torch.observability.cost import batch_bucket, instrument_site
from veomni_tpu_torch.observability.flight_recorder import (
    configure_flight_recorder,
    dump_postmortem,
    record as flight_record,
)
from veomni_tpu_torch.observability.spans import span
from veomni_tpu_torch.optim import build_lr_scheduler, build_optimizer
from veomni_tpu_torch.optim.optimizer import split_mixed_groups, with_param_groups
from veomni_tpu_torch.parallel import init_parallel_state, use_parallel_state
from veomni_tpu_torch.parallel.parallel_plan import (
    ParallelPlan,
    apply_parallel_plan,
    lora_parallel_plan_rules,
    model_parallel_plan,
)
from veomni_tpu_torch.parallel.sequence_parallel import sp_slice
from veomni_tpu_torch.train import build_train_state, build_train_step
from veomni_tpu_torch.trainer.callbacks import (
    CheckpointCallback,
    EnvironMeterCallback,
    EvaluateCallback,
    HFCheckpointCallback,
    LoggingCallback,
    ProfileCallback,
    TrainerControlState,
    WandbCallback,
)
from veomni_tpu_torch.utils.count_flops import FlopsCounter
from veomni_tpu_torch.utils.device import resolve_device
from veomni_tpu_torch.utils.helper import EnvironMeter, set_seed
from veomni_tpu_torch.utils.logging import _process_index, get_logger

logger = get_logger(__name__)

BATCH_KEYS = ("input_ids", "labels", "position_ids", "segment_ids")
# the data transforms of the text trainer; VLMTrainer adds the qwen-vl ones
SUPPORTED_DATA_TYPES = ("pretokenized", "plaintext", "conversation")


def check_supported(args: VeOmniArguments, data_types=SUPPORTED_DATA_TYPES) -> None:
    """Raise ``NotImplementedError`` naming every configured knob whose
    module is not ported yet (the trainer's counterpart of
    ``models/transformer.py::check_supported``); ``data_types`` are the
    data transforms the calling trainer runs."""
    d, t = args.data, args.train
    missing = [f"{knob} ({why})" for knob, why, on in (
        (f"data.data_type {d.data_type!r}", "the qwen2-vl and qwen2.5-vl transforms run "
         "through VLMTrainer, tasks/train_vlm.py; the other multimodal ones are slice F",
         d.data_type not in data_types),
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


def _launcher_world():
    """(rank, world size, local rank, init method) from the environment, or
    None when it asks for one process: the reference's three ``VEOMNI_*``
    variables (``:57-90``), a launcher's ``RANK``/``WORLD_SIZE``/
    ``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``, or
    ``VEOMNI_AUTO_DISTRIBUTED=1`` (the launcher's ``env://``)."""
    env = os.environ
    coord = env.get("VEOMNI_COORDINATOR_ADDRESS")
    if coord:
        world = int(env["VEOMNI_NUM_PROCESSES"])
        rank = int(env["VEOMNI_PROCESS_ID"])
        return rank, world, int(env.get("LOCAL_RANK", rank)), f"tcp://{coord}"
    if int(env.get("WORLD_SIZE", "1") or 1) > 1:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init = (f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
                if env.get("MASTER_PORT") else "env://")
        return rank, world, int(env.get("LOCAL_RANK", rank)), init
    if env.get("VEOMNI_AUTO_DISTRIBUTED") == "1":
        return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0)), "env://"
    return None


def maybe_initialize_distributed(device: torch.device) -> torch.device:
    """Join the process group the launcher's environment asks for and
    return this rank's device: ``cuda:(LOCAL_RANK % cards)`` on the card,
    the CPU when asked. The backend is NCCL when every local rank has a card
    of its own, else gloo (the CPU, or ranks sharing a card: NCCL refuses
    two ranks on one device); the choice is logged. A no-op (the device
    unchanged) for one process or a group that exists already."""
    import torch.distributed as dist

    world = _launcher_world()
    if device.type == "cuda" and world is not None:
        device = torch.device("cuda", world[2] % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if world is None or (dist.is_available() and dist.is_initialized()):
        return device
    rank, size, local_rank, init = world
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    own_cards = device.type == "cuda" and local_world <= torch.cuda.device_count()
    backend = "nccl" if own_cards else "gloo"
    logger.info("rank %d of %d joins %s over %s on %s (%s)", rank, size, init, backend, device,
                "one card a rank" if own_cards else
                "ranks share a card: NCCL keeps one rank a device" if device.type == "cuda"
                else "CPU ranks")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=size, **kwargs)
    return device


def spawn_virtual_devices(args: VeOmniArguments, module: str, argv) -> Optional[int]:
    """``train.num_virtual_devices: N`` with ``platform: cpu`` is the JAX
    package's simulated CPU mesh of N devices; its counterpart here is N CPU
    ranks over gloo. Outside a launcher's world, an entry point re-runs
    itself as those N processes and returns their exit code; inside one
    (or without the knob) this returns None and the caller trains."""
    n = args.train.num_virtual_devices
    if n <= 0 or args.train.platform != "cpu" or _launcher_world() is not None:
        return None
    import sys

    from veomni_tpu_torch.parallel.launch import spawn_entry_point

    logger.info_rank0("train.num_virtual_devices %d: starting %d CPU ranks over gloo", n, n)
    return spawn_entry_point(n, list(sys.argv[1:] if argv is None else argv), module)


def run_entry_point(trainer_cls, argv, module: str):
    """The task entry points' body: parse the command line (or ``argv``),
    start the ``num_virtual_devices`` CPU ranks when asked
    (:func:`spawn_virtual_devices`; then None is returned once they exit
    cleanly), else build ``trainer_cls`` and train; returns the trainer."""
    from veomni_tpu_torch.arguments import parse_args, save_args

    args = parse_args(VeOmniArguments, argv)
    code = spawn_virtual_devices(args, module, argv)
    if code is not None:
        if code:
            raise SystemExit(code)
        return None
    if _process_index() == 0:
        save_args(args, args.train.output_dir)
    trainer = trainer_cls(args)
    trainer.train()
    return trainer


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
    BATCH_KEYS = BATCH_KEYS
    SUPPORTED_DATA_TYPES = SUPPORTED_DATA_TYPES

    def __init__(self, args: VeOmniArguments):
        self.args = args
        self.current_batch: Optional[Dict[str, np.ndarray]] = None
        self.meter: Optional[EnvironMeter] = None
        check_supported(args, self.SUPPORTED_DATA_TYPES)
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
        self.device = maybe_initialize_distributed(resolve_platform(t.platform))
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
            device_type=self.device.type,
        )
        if t.num_virtual_devices and t.num_virtual_devices != self.parallel_state.world_size:
            logger.warning_rank0(
                "train.num_virtual_devices %d: a rank is one process here, and the mesh has "
                "the world's %d ranks (start N ranks through the entry point)",
                t.num_virtual_devices, self.parallel_state.world_size)
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
        if self.args.train.ulysses_async:
            # the chunked all-to-all/attention pipeline of the Ulysses wrap
            ops_pins.setdefault("ulysses", "ulysses_async")
            overrides.setdefault("ulysses_async_chunks", self.args.train.ulysses_async_chunks)
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

    def data_shard(self) -> Dict[str, int]:
        """This rank's share of the data: ``micro_batch_size`` rows a
        micro-batch from its dp slice (``dp_rank`` is its position along the
        dp axes, not its process rank: the sp peers of one dp index load the
        same rows and each keeps its sequence chunk, ``_ship_batch``)."""
        ps = self.parallel_state
        return {"rows": self.args.train.micro_batch_size, "dp_rank": ps.data_parallel_index(),
                "dp_size": ps.dp_size}

    def _build_dataloader(self):
        t, d = self.args.train, self.args.data
        ps = self.parallel_state
        shard = self.data_shard()
        self.grad_accum_steps = self.args.compute_grad_accum(ps.dp_size)
        local_mb = shard["rows"]
        collator = TextPackingCollator(
            seq_len=d.max_seq_len,
            micro_batch_size=local_mb,
            sp_size=ps.sp_size,
            with_channels=bool(d.channel_list),
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
                dp_rank=shard["dp_rank"],
                dp_size=shard["dp_size"],
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
                dp_rank=shard["dp_rank"],
                dp_size=shard["dp_size"],
                drop_last=d.drop_last,
                infinite=True,
            )

    def _build_parallelized_state(self):
        """Schedule, model init on the run's device, the parallel plan
        applied over the mesh (``parallel/parallel_plan.py``: FSDP2 shards,
        expert slices; nothing at world size 1), optimizer, train state,
        train step, meter and checkpointer (the reference's ``:283``)."""
        t = self.args.train
        steps = t.train_steps or max(1, len(self.dataloader) * t.num_train_epochs)
        self.train_steps = steps
        self.lr_schedule = build_lr_scheduler(
            t.lr_decay_style, lr=t.lr, train_steps=steps,
            lr_warmup_ratio=t.lr_warmup_ratio, lr_min=t.lr_min,
        )
        m = self.args.model
        ps = self.parallel_state
        if m.model_path:
            # each rank reads the tensors itself (train.broadcast_weights_
            # from_rank0 is not read), under expert parallelism only its
            # experts'; the plan then keeps its part
            experts = None
            n_experts = getattr(getattr(self.model.config, "text", self.model.config),
                                "num_experts", 0)
            if ps.ep_enabled and n_experts:
                e_loc = n_experts // ps.ep_size
                r = ps.coords["ep"]
                experts = range(r * e_loc, (r + 1) * e_loc)
            module = self.model.load_hf(m.model_path, device=self.device, experts=experts)
        else:
            module = self.model.init(self.generator, device=self.device)
        self.lora_config = LoraConfig.from_dict(m.lora)
        if self.lora_config is not None:
            # frozen base + trainable adapters (reference :312-373); over a
            # mesh the plan's LoRA rules merge in (:350-357)
            self.base_model = module
            trainable = init_lora_params(self.generator, module, self.lora_config)
            if m.lora_adapter_path:
                load_adapter(m.lora_adapter_path, trainable)
            self.base_layout = apply_parallel_plan(module, ps, frozen=True)
            self.layout = apply_parallel_plan(trainable, ps, model_parallel_plan(
                self.model.config).merge(ParallelPlan(rules=lora_parallel_plan_rules())))
            loss_fn = apply_lora_to_loss_fn(self._inner_loss_fn(), module)
        else:
            self.base_model = self.base_layout = None
            trainable = module
            self.layout = apply_parallel_plan(module, ps)
            loss_fn = self._inner_loss_fn()
        if self.layout is not None:
            # the root's FSDP2 forward: its own parameters gathered for the call
            loss_fn = self.layout.entry(loss_fn)
        self.optimizer = build_optimizer(
            trainable, optimizer=t.optimizer, lr=self.lr_schedule, betas=tuple(t.betas),
            weight_decay=t.weight_decay,
        )
        named = named_jax_parameters(trainable)
        if m.freeze_modules or t.module_lr_scales:
            self.optimizer = with_param_groups(
                self.optimizer, named, freeze_patterns=tuple(m.freeze_modules),
                lr_scales=dict(t.module_lr_scales))
        # frozen modules' grads are zeroed before the clip (reference :398-410)
        self.grad_mask = [p for path, p in named
                          if any(re.search(pat, path) for pat in m.freeze_modules)]
        if self.layout is not None:
            self.optimizer = split_mixed_groups(self.optimizer)
            if hasattr(self.optimizer, "leaves"):
                self.optimizer.layout = self.layout  # whole leaves over the mesh
        self.train_state = build_train_state(trainable, self.optimizer)
        # the hot step and, built on first use, the numerics sibling
        self._step_options = dict(
            max_grad_norm=t.max_grad_norm, grad_mask=self.grad_mask or None,
            scope=LoraAdapters.merged if self.base_model is not None else None,
            skip_nonfinite=t.resilience_skip_nonfinite, layout=self.layout,
        )
        # the cost census counts each batch shape's first step (observability/cost.py)
        self.train_step = instrument_site("train_step", build_train_step(
            loss_fn, **self._step_options), bucket_fn=lambda args: batch_bucket(args[1]))
        self._numerics_step = None
        self._numerics = None
        self._loss_fn = loss_fn  # what evaluate() scores
        self.meter = EnvironMeter(
            flops_counter=FlopsCounter.from_config(self.model.config),
            world_size=self.parallel_state.world_size,
            device=self.device,
            reduce=self._dp_sum if self.parallel_state.world_size > 1 else None,
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
            layout=self.layout,
        )

    def _dp_sum(self, values):
        """Per-rank batch stats summed over the dp shards: over dp×sp, where
        the sp peers of a dp index count the same rows, then over sp."""
        import torch.distributed as dist

        ps = self.parallel_state
        group = ps.group(ps.dp_sp_axes)
        if group is None:  # one dp shard, no sp: tp or pp ranks repeat the work
            return values
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, group=group)
        return (t / ps.sp_size).tolist()

    def barrier(self) -> None:
        """Every rank waits for the others (a no-op for one process)."""
        import torch.distributed as dist

        if self.parallel_state.world_size > 1:
            dist.barrier()

    def unsharded_for_export(self):
        """(the trained module, the frozen LoRA base or None) whole on rank 0
        for an export; over a mesh, copies on the host gathered from the
        shards (a collective: every rank calls it), and (None, None) on the
        other ranks."""
        import torch.distributed as dist

        module, base = self.train_state.model, self.base_model
        if self.layout is None:
            return module, base
        full = self.layout.full_state_dict()
        full_base = self.base_layout.full_state_dict() if base is not None else None
        if dist.get_rank() != 0:
            return None, None
        copy = self.model._build(None, "cpu")
        if base is None:
            copy.load_state_dict({k: v.cpu() for k, v in full.items()})
            return copy, None
        copy.load_state_dict({k: v.cpu() for k, v in full_base.items()})
        adapters = init_lora_params(None, copy, self.lora_config)
        adapters.load_state_dict({k: v.cpu() for k, v in full.items()})
        return adapters, copy

    def _inner_loss_fn(self):
        """``loss_fn(module, batch)`` over the full model (a LoRA merge
        wraps it outside): the per-channel loss when ``data.channel_list``
        is set, else the model's own; the post-training trainers override
        it with their objectives."""
        if self.args.data.channel_list:
            from veomni_tpu_torch.train.channel_loss import make_channel_loss_fn

            return make_channel_loss_fn(len(self.args.data.channel_list))
        return self.model.loss_fn

    def _init_callbacks(self):
        from veomni_tpu_torch.observability.callback import ObservabilityCallback

        t, d = self.args.train, self.args.data
        self.callbacks = [
            EnvironMeterCallback(self.meter),
            # after the meter (its rollup must be in the published payload),
            # before Logging/Wandb (they consume the registry export)
            ObservabilityCallback(),
            LoggingCallback(),
        ]
        if d.channel_list:
            from veomni_tpu_torch.train.channel_loss import ChannelLossCallback

            # before the checkpoint, so that a save at step N holds step N's
            # sums (after it, as in the reference, a resume from N loses them)
            self.callbacks.append(ChannelLossCallback(d.channel_list, t.log_steps * 10))
        self.callbacks.append(CheckpointCallback(self.checkpointer, t.save_steps))
        if d.eval_path:
            self.callbacks.append(EvaluateCallback(t.eval_steps))
        if t.enable_profiling:
            self.callbacks.append(
                ProfileCallback(t.output_dir, t.profile_start_step, t.profile_end_step)
            )
        if t.save_hf_weights:
            self.callbacks.append(HFCheckpointCallback())
        if t.use_wandb:
            import dataclasses

            self.callbacks.append(WandbCallback(t.wandb_project, t.wandb_name,
                                                config=dataclasses.asdict(self.args)))

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

    # ------------------------------------------------------------- evaluation
    def _build_eval_dataloader(self):
        """The eval pipeline on ``data.eval_path`` through the subclass's own
        ``_build_dataset`` and ``_build_dataloader`` (the training transform
        and collator)."""
        saved = (self.dataset, self.dataloader, self.args.data.train_path)
        self.args.data.train_path = self.args.data.eval_path
        try:
            self._build_dataset()
            self._build_dataloader()
            return self.dataloader
        finally:
            self.dataset, self.dataloader, self.args.data.train_path = saved

    @torch.no_grad()
    def evaluate(self) -> Optional[float]:
        """Forward-only mean loss of the trainer's own objective
        (``self._loss_fn``: a post-training trainer scores its DPO, distill
        or RL loss) over ``train.eval_batches`` batches of
        ``data.eval_path``, micro-batch by micro-batch: the loss sums over
        the ``ntokens`` sums. The eval dataloader is rebuilt on every call,
        so with the fixed seed each call reads the same slice and the
        values of different steps compare. Each micro-batch shape's first
        eval step is counted into the cost census (``eval_step``)."""
        if not self.args.data.eval_path:
            return None
        if getattr(self, "_eval_step", None) is None:
            self._eval_step = instrument_site(
                "eval_step", lambda model, batch: self._loss_fn(model, batch),
                bucket_fn=lambda args: batch_bucket(args[1]))
        it = iter(self._build_eval_dataloader())
        total, ntok = 0.0, 0.0
        for _ in range(self.args.train.eval_batches):
            try:
                batch_np = next(it)
            except StopIteration:
                break
            batch = self._ship_batch(batch_np)
            for a in range(next(iter(batch.values())).shape[0]):
                loss_sum, metrics = self._eval_step(self.train_state.model,
                                                    {k: v[a] for k, v in batch.items()})
                total += float(loss_sum)
                ntok += float(metrics["ntokens"])
        return total / max(ntok, 1.0)

    #: batch keys whose sequence dim stays whole under sequence parallelism
    SP_WHOLE_KEYS: tuple = ()

    def _ship_batch(self, batch_np):
        """Host batch -> device tensors: numpy -> pinned host tensor ->
        asynchronous copy to the card (plain tensors on the CPU). The
        class's keys, and ``channel_ids`` under ``data.channel_list``.
        Under sequence parallelism each [A, B, S, ...] tensor keeps this
        rank's chunk of S (mrope positions [A, B, 3, S] their last dim);
        labels come pre-shifted from the collator, so no shift is needed."""
        ps = self.parallel_state
        out = {}
        for k in self.BATCH_KEYS + (("channel_ids",) if self.args.data.channel_list else ()):
            if k not in batch_np:
                continue
            t = torch.from_numpy(batch_np[k])
            if ps.sp_enabled and k not in self.SP_WHOLE_KEYS and t.ndim >= 3:
                t = sp_slice(t, ps, dim=3 if k == "position_ids" and t.ndim == 4 else 2)
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
        """Post-mortem payload for an exception escaping train(): a card
        out-of-memory error also carries the buffer census and the cost
        census (``observability/devmem.py``), and a run with the numerics
        observatory armed its provenance and health history. Never raises:
        forensics must not mask the original failure."""
        extra: Dict[str, Any] = {"error": str(e)[:2000],
                                 "global_step": global_step}
        try:
            from veomni_tpu_torch.observability.devmem import attach_oom_extra

            attach_oom_extra(e, extra)
        except Exception as forensic_err:
            extra["oom_report_error"] = str(forensic_err)
        try:
            from veomni_tpu_torch.observability.numerics import attach_numerics_extra

            attach_numerics_extra(extra)
        except Exception as forensic_err:
            extra["numerics_report_error"] = str(forensic_err)
        return extra

    # -------------------------------------------------------------- numerics
    def _get_numerics_step(self):
        """The instrumented sibling of the train step (numerics observatory),
        built on first use with the hot step's loss fn and options."""
        if self._numerics_step is None:
            from veomni_tpu_torch.observability.numerics import NumericsSpec

            self._numerics_step = instrument_site("numerics_step", build_train_step(
                self._loss_fn, **self._step_options,
                numerics_spec=NumericsSpec(
                    max_groups=self.args.train.observability_numerics_max_groups),
            ), bucket_fn=lambda args: batch_bucket(args[1]))
        return self._numerics_step

    def _diagnose_numerics(self, ctl, batch) -> None:
        """Supervisor anomaly tie-in: re-run the same batch through the
        instrumented step without applying its update (parameters, moments
        and update count stay bit-unchanged), and turn the health tree into
        the provenance document before the verdict escalates. Never raises."""
        if self._numerics is None:
            return
        try:
            with span("numerics.diagnose"):
                _state, _metrics, health = self._get_numerics_step()(
                    self.train_state, batch, apply=False)
                doc = self._numerics.diagnose(
                    ctl.global_step, health,
                    injected=self._supervisor.last_anomaly_injected)
            ctl.resilience = {**ctl.resilience,
                              "numerics_first_nonfinite": doc.get("first_nonfinite")}
        except Exception as e:
            logger.warning_rank0("numerics diagnosis failed: %s", e)

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
        # numerics observatory: the process's active monitor, so that
        # /debug/numerics and the post-mortem see it; knob off, no tier
        numerics_interval = max(0, t.observability_numerics_interval)
        if numerics_interval:
            from veomni_tpu_torch.observability.numerics import (
                NumericsMonitor,
                set_active_monitor,
            )

            self._numerics = NumericsMonitor(history=t.observability_numerics_history)
            set_active_monitor(self._numerics)
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
                self._release_numerics()
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
                                from veomni_tpu_torch.observability.numerics import (
                                    poison_param_group,
                                )

                                target = poison_param_group(self.train_state.model, act.target)
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
                            # every interval-th step runs the instrumented
                            # sibling in place of the hot step: the same update,
                            # plus the health tree the monitor publishes
                            numerics_due = bool(
                                numerics_interval
                                and (ctl.global_step + 1) % numerics_interval == 0)
                            health = None
                            with span("step.dispatch"):
                                if numerics_due:
                                    self.train_state, metrics, health = (
                                        self._get_numerics_step()(self.train_state, batch))
                                else:
                                    self.train_state, metrics = self.train_step(
                                        self.train_state, batch
                                    )
                            ctl.global_step += 1
                            if health is not None:
                                with span("numerics.observe"):
                                    self._numerics.observe(ctl.global_step, health)
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
                            if verdict != "ok":
                                # attribute the anomaly (which group first went
                                # non-finite) before the verdict escalates
                                self._diagnose_numerics(ctl, batch)
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
                # after the post-mortem above, which still reads the monitor
                self._release_numerics()
        return ctl

    def _release_numerics(self) -> None:
        """Unregister this run's numerics monitor (only our own: a second
        trainer in the process may have installed its own)."""
        if self._numerics is not None:
            from veomni_tpu_torch.observability.numerics import (
                get_active_monitor,
                set_active_monitor,
            )

            if get_active_monitor() is self._numerics:
                set_active_monitor(None)
