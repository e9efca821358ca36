"""Config dataclass tree: VeOmniArguments{model, data, train}.

Reference: ``veomni/arguments/arguments_types.py:1440`` — the YAML/CLI
surface is the north star for drop-in familiarity (SURVEY.md §7.2 step 1),
so field names follow the reference where the concept exists on TPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ModelArguments:
    config_path: str = ""            # dir with config.json (HF format)
    model_path: str = ""             # dir with safetensors weights ("" = random init)
    tokenizer_path: str = ""         # defaults to config_path
    model_type: str = ""             # override/bypass config.json model_type
    attn_implementation: str = "auto"    # auto|xla|xla_chunked|xla_twopass|pallas_flash
    moe_implementation: str = "auto"     # auto|xla|xla_ragged|pallas|pallas_gmm
    ops_implementation: Dict[str, str] = field(default_factory=dict)  # op -> impl pin
    # tiny-model construction without config.json (tests/toy configs)
    config_overrides: Dict[str, Any] = field(default_factory=dict)
    # LoRA: {} disables; {"rank": 8, "alpha": 16, ...} -> LoraConfig fields
    lora: Dict[str, Any] = field(default_factory=dict)
    # resume adapter-only checkpoint from this dir ("" = fresh adapters)
    lora_adapter_path: str = ""
    # param-path regexes whose updates are zeroed (reference freeze toggles,
    # e.g. ["^vision_tower"] to freeze a ViT); composes with LoRA
    freeze_modules: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.tokenizer_path:
            self.tokenizer_path = self.config_path


@dataclass
class DataArguments:
    train_path: str = ""
    eval_path: str = ""
    data_type: str = "plaintext"      # plaintext|conversation|pretokenized
    dataset_type: str = "mapping"     # mapping|iterable|interleave|weighted
    dataloader_type: str = "native"
    max_seq_len: int = 2048
    text_keys: str = "text"
    chat_template: str = "default"
    num_workers: int = 0              # data assembly is in-process (numpy)
    drop_last: bool = True
    dyn_bsz: bool = False             # token-budget dynamic batching
    dyn_bsz_buffer_size: int = 200
    # per-source loss accounting: names of data channels; samples carry a
    # "channel" field (name or index). Empty = disabled.
    channel_list: List[str] = field(default_factory=list)
    samples_per_micro_batch: int = 8  # packing fill pool per micro-batch
    # static packed vision-patch budget per micro-batch (qwen2_5_vl pipeline);
    # also the per-sample cap in the transform
    max_patches: int = 4096
    # static audio chunk budget per micro-batch (qwen3_omni pipeline; one
    # chunk = 2*n_window mel frames)
    max_audio_chunks: int = 64


@dataclass
class TrainingArguments:
    output_dir: str = "output"
    # force a JAX platform ("cpu" etc.; "" = default). With num_virtual_devices
    # this enables multi-device CPU simulation runs of the full CLI.
    platform: str = ""
    num_virtual_devices: int = 0
    # batch geometry
    micro_batch_size: int = 1
    global_batch_size: int = 0        # 0 -> micro * dp_size (no grad accum)
    # parallel sizes (reference AcceleratorConfig, arguments_types.py:465-526)
    data_parallel_mode: str = "fsdp"  # fsdp|ddp  (ddp = dp_replicate only)
    data_parallel_replicate_size: int = 1
    data_parallel_shard_size: int = -1
    ulysses_parallel_size: int = 1
    # Async Ulysses (parallel/async_ulysses.py): pipeline the chunked head
    # a2a against the previous chunk's attention compute instead of one
    # monolithic a2a (the reference's async_ulysses engine, compiler-
    # scheduled on TPU). Only meaningful with ulysses_parallel_size > 1.
    ulysses_async: bool = False
    # head-chunk count for the async pipeline (clamped to the model's
    # feasible head layout; more chunks = finer overlap, more collectives)
    ulysses_async_chunks: int = 4
    context_parallel_size: int = 1
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    expert_parallel_size: int = 1
    # optimization
    optimizer: str = "adamw"
    lr: float = 1e-5
    lr_decay_style: str = "cosine"
    lr_warmup_ratio: float = 0.0
    lr_min: float = 0.0
    weight_decay: float = 0.0
    betas: List[float] = field(default_factory=lambda: [0.9, 0.999])
    max_grad_norm: float = 1.0
    # per-module LR multipliers: {param-path regex: scale} (reference
    # per-group LR, vlm_trainer.py vit_lr etc.)
    module_lr_scales: Dict[str, float] = field(default_factory=dict)
    dpo_beta: float = 0.1
    ppo_clip_ratio: float = 0.2
    # top-k distillation (trainer/distill_trainer.py)
    distill_topk: int = 8
    distill_kl_coef: float = 1.0
    distill_temperature: float = 1.0
    # schedule/steps
    train_steps: int = 0              # 0 -> derive from epochs * len(dataloader)
    num_train_epochs: int = 1
    # numerics (reference MixedPrecisionConfig: compute bf16, master f32)
    bf16: bool = True
    param_dtype: str = "float32"   # master/optimizer param dtype
    enable_gradient_checkpointing: bool = True
    # remat policy: nothing|dots|offload (reference GradientCheckpointing +
    # activation-offload configs; offload saves matmul outputs to host RAM)
    gradient_checkpointing_policy: str = "nothing"
    # ChunkMBS sequence-chunked MLP length, 0 = off (reference ChunkMBS config)
    chunk_mbs: int = 0
    enable_full_determinism: bool = False
    seed: int = 42
    # checkpoint
    # multihost HF weight load: replicated params read once on process 0 and
    # broadcast over the interconnect instead of N filesystem reads
    # (sharded params always stream only their local slices)
    broadcast_weights_from_rank0: bool = False
    ckpt_manager: str = "orbax"
    save_steps: int = 0               # 0 = only at end
    save_hf_weights: bool = True
    load_checkpoint_path: str = ""    # resume dir ("" = output_dir/checkpoints)
    auto_resume: bool = True
    max_ckpt_to_keep: int = 0
    async_save: bool = True
    # evaluation (runs forward-only loss over data.eval_path; the reference's
    # EvaluateCallback is a TODO stub — this one is real)
    eval_steps: int = 0               # every N steps (0 = at train end only if eval_path set)
    eval_batches: int = 32            # micro-batches per evaluation
    # input pipeline: host batches assembled this many steps ahead on a
    # worker thread (reference BackgroundPrefetcher); 0 = synchronous
    prefetch_depth: int = 2
    # resilience (veomni_tpu/resilience/): anomaly supervision + recovery.
    # Device-side gate: a step with non-finite loss/grad leaves params and
    # optimizer state untouched (exact no-op for finite steps)
    resilience_skip_nonfinite: bool = True
    # total anomalous steps tolerated before the run aborts loudly
    resilience_anomaly_budget: int = 8
    # consecutive anomalies that trigger rollback to the latest committed
    # checkpoint (restoring the rank-local data cursor + replaying)
    resilience_rollback_after: int = 3
    # rollbacks tolerated before escalating to abort
    resilience_max_rollbacks: int = 2
    # retry budget for checkpoint save/restore I/O (extra attempts after the
    # first; deterministic exponential backoff, no jitter)
    resilience_io_retries: int = 3
    resilience_retry_base_s: float = 0.05
    # train-loop stall watchdog: dump all thread stacks if no step completes
    # within this many seconds (0 = disabled)
    resilience_watchdog_s: float = 0.0
    # checkpoint integrity gate (resilience/integrity.py): manifest
    # verification before every restore. "off" = trust the bytes; "size" =
    # existence + byte size (catches truncation/missing files at
    # directory-listing cost); "full" = re-digest every file (catches bit
    # flips; reads the whole checkpoint). A failing generation is
    # quarantined (global_step_N.corrupt) and restore falls back to the
    # next-newest committed-and-verified one.
    ckpt_verify: str = "size"
    # elastic restore (resilience/elastic.py): allow resuming a checkpoint
    # saved on a different data-parallel topology (mesh/world resize) —
    # global arrays reshard onto the target NamedShardings and the per-rank
    # data cursors + skip-budget accounting merge/split deterministically.
    # Model-parallel degree changes (tp/ep/ulysses/cp/pp) stay refused with
    # an actionable error. Off (default): any topology mismatch errors
    # instead of silently restoring partial cursor state.
    ckpt_elastic: bool = False
    # poison-record tolerance for streaming data: how many distinct
    # undecodable/invalid (shard, record) pairs may be skipped before the
    # run fails fast with full provenance. 0 = fail on the first one.
    # Skips are recorded in the rank-local checkpoint state so a resumed
    # run replays them bit-exactly.
    data_skip_budget: int = 0
    # observability. log_steps is also the host<->device sync cadence: the
    # loop only fetches metrics (blocking on the device) every log_steps —
    # default 10 so the async loop's lazy sync is ON out of the box (a
    # per-step device fetch serializes batch assembly with compute; the
    # dispatch-depth bound in the trainer caps run-ahead independently)
    log_steps: int = 10
    # unified observability layer (veomni_tpu/observability/, see
    # docs/observability.md). Spans: host-side phase timing feeding the
    # goodput decomposition (disabled spans cost ~nothing, but off means no
    # stall attribution)
    observability_spans: bool = True
    # rank-local metrics JSONL (output_dir/metrics_rank{R}.jsonl), one line
    # per sync step: the offline utilization trajectory
    observability_jsonl: bool = True
    # serve Prometheus /metrics + supervisor-backed /healthz on this port;
    # 0 = off, negative = ephemeral (tests). VEOMNI_METRICS_PORT overrides.
    observability_port: int = 0
    # dump the host span buffer as chrome-trace JSON here at train end
    # ("" = off; merge across hosts with scripts/merge_chrome_trace.py)
    observability_chrome_trace: str = ""
    # always-on flight recorder (observability/flight_recorder.py): bounded
    # ring of structured events (step lifecycle, checkpoint commits,
    # supervisor verdicts, retries, fault hits) dumped to
    # output_dir/postmortem-<rank>.json on watchdog fire / supervisor abort
    # / uncaught exception / SIGTERM. Ring size in events; 0 disables.
    observability_flight_events: int = 4096
    # fleet tier (observability/fleet.py): per-sync-window per-rank
    # step-time skew exchange (one tiny all-gather of a handful of floats;
    # automatically off below 2 processes), straggler warnings +
    # fleet.straggler flight events, and a host-side heartbeat file per
    # rank (output_dir/heartbeat-<rank>.json) so a WEDGED rank is
    # diagnosable from outside the process. 0 disables the tier entirely.
    observability_fleet: int = 1
    # a rank whose window-mean step time exceeds the fleet median by this
    # factor is named a straggler (rank-0 warning + flight event)
    observability_straggler_factor: float = 2.0
    # numerics & training-health observatory (observability/numerics.py):
    # every N steps the trainer runs the INSTRUMENTED sibling train step
    # (same update math, one extra compiled program) that additionally
    # emits per-param-group grad/param RMS, absmax, non-finite counts,
    # update/weight ratio and dtype overflow-margin bits (scan-stacked
    # layers as per-layer vectors), published as numerics.* gauges +
    # /debug/numerics. When the resilience supervisor flags an anomalous
    # step, the same already-fetched batch is re-run through it to produce
    # a non-finite provenance doc (first offending group, grad vs param vs
    # update) for the flight recorder and the anomaly post-mortem.
    # 0 (default) = off: the training trajectory is byte-identical to a
    # build without the tier.
    observability_numerics_interval: int = 0
    # cardinality cap on numerics param groups (deterministic coarsening:
    # leaf paths collapse toward subtree roots, overflow merges into a
    # '...rest' bucket)
    observability_numerics_max_groups: int = 64
    # health summaries retained in the in-memory history ring that rides
    # into provenance docs, post-mortems and /debug/numerics
    observability_numerics_history: int = 32
    enable_profiling: bool = False
    # VEOMNI_PROFILE_START / VEOMNI_PROFILE_END env vars override the window
    profile_start_step: int = 3
    profile_end_step: int = 5
    use_wandb: bool = False
    wandb_project: str = "veomni_tpu"
    wandb_name: str = ""

    @property
    def compute_dtype(self):
        import torch

        return torch.bfloat16 if self.bf16 else torch.float32


@dataclass
class VeOmniArguments:
    model: ModelArguments = field(default_factory=ModelArguments)
    data: DataArguments = field(default_factory=DataArguments)
    train: TrainingArguments = field(default_factory=TrainingArguments)

    def compute_grad_accum(self, dp_size: int) -> int:
        """global_batch_size = micro_batch_size * dp_size * grad_accum
        (reference compute_train_steps, parser.py:64-211)."""
        if not self.train.global_batch_size:
            return 1
        g = self.train.global_batch_size
        per_step = self.train.micro_batch_size * dp_size
        if g % per_step:
            raise ValueError(
                f"global_batch_size {g} not divisible by micro*dp {per_step}"
            )
        return g // per_step
