"""Reference-schema YAML translation: a VeOmni recipe drops in unchanged.

Reference: ``veomni/arguments/arguments_types.py`` — the nested config blocks
(``train.accelerator.*`` with ``fsdp_config``/``offload_config``,
``train.optimizer.*``, ``train.checkpoint.*``, ``train.wandb.*``,
``train.profile.*``, ``model.lora_config``, ``data.dataloader`` …). This
module rewrites those blocks into the flat TPU-native schema before the
dataclass apply, so reference YAMLs parse directly:

* concepts that exist here are RENAMED/FLATTENED (ep_size ->
  expert_parallel_size, optimizer.lr -> lr, checkpoint.manager dcp -> orbax…);
* GPU-only knobs with no TPU counterpart (init_device, empty_cache_steps,
  FSDP reshard/prefetch toggles, torch-profiler details…) are DROPPED with a
  warning naming each key;
* keys this translator doesn't recognize inside a reference block warn
  instead of crashing — but a native-schema file keeps exact-match typo
  safety because translation only fires on reference-schema keys.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

from veomni_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# GPU-impl names -> our kernel-registry pins, per op (reference
# ``model.ops_implementation``; "auto" defers to the registry's device pick)
_OPS_IMPL_MAP = {
    "attn_implementation": ("attn_implementation", {
        "eager": "xla", "sdpa": "auto", "flash_attention_2": "auto",
        "flex_attention": "auto",
    }),
    "moe_implementation": ("moe_implementation", {
        "eager": "xla", "fused_triton": "auto", "fused": "auto",
    }),
    "cross_entropy_loss_implementation": ("fused_linear_cross_entropy", {
        "eager": "xla", "liger_kernel": "auto", "chunk_loss": "xla_chunked",
        "npu": "auto",
    }),
    "rms_norm_implementation": ("rms_norm", {"eager": "xla", "liger_kernel": "auto"}),
    "swiglu_mlp_implementation": ("swiglu", {"eager": "xla", "liger_kernel": "auto"}),
    "rotary_pos_emb_implementation": ("rotary", {"eager": "xla", "liger_kernel": "auto"}),
}


def _warn(notes: List[str], key: str, reason: str) -> None:
    notes.append(f"{key}: {reason}")


def _pop_map(src: Dict, out: Dict, mapping: Dict[str, str], prefix: str,
             notes: List[str]) -> None:
    """Move recognized keys of ``src`` into ``out`` under new names; warn on
    the rest."""
    for k in list(src):
        if k in mapping:
            out[mapping[k]] = src.pop(k)
    for k in src:
        _warn(notes, f"{prefix}.{k}", "no TPU counterpart, ignored")


def _translate_model(model: Dict[str, Any], notes: List[str]) -> None:
    mods = model.pop("lora_target_modules", None)
    if mods:
        model.setdefault("lora", {})["target_patterns"] = [
            rf"(^|\.)(?:{'|'.join(mods)})$"
        ]
    if "lora_rank" in model:
        model.setdefault("lora", {})["rank"] = model.pop("lora_rank")
    if "lora_alpha" in model:
        model.setdefault("lora", {})["alpha"] = model.pop("lora_alpha")
    for k in ("condition_model_path", "teacher_model_path", "input_encoder",
              "output_decoder", "encode_target", "decode_target",
              "foundation_model_path"):
        if k in model:
            _warn(notes, f"model.{k}",
                  "reference-specific model-assembly knob, ignored")
            model.pop(k)
    ops = model.get("ops_implementation")
    # the native schema reuses this field name as {op: impl} pins — only a
    # dict holding reference ``*_implementation`` keys gets translated
    if isinstance(ops, dict) and any(k in _OPS_IMPL_MAP for k in ops):
        model["ops_implementation"] = {}
        for key, val in ops.items():
            if key in _OPS_IMPL_MAP:
                target, impl_map = _OPS_IMPL_MAP[key]
                impl = impl_map.get(str(val))
                if impl is None:
                    _warn(notes, f"model.ops_implementation.{key}",
                          f"unknown impl {val!r}, using auto")
                    impl = "auto"
                if target in ("attn_implementation", "moe_implementation"):
                    model[target] = impl
                elif impl != "auto":
                    model["ops_implementation"][target] = impl
            else:
                _warn(notes, f"model.ops_implementation.{key}",
                      "unrecognized op field, ignored")
    lora = model.pop("lora_config", None)
    if isinstance(lora, dict):
        out: Dict[str, Any] = {}
        if "rank" in lora:
            out["rank"] = lora.pop("rank")
        if "alpha" in lora:
            out["alpha"] = lora.pop("alpha")
        mods = lora.pop("lora_modules", None)
        if mods:
            out["target_patterns"] = [rf"(^|\.)(?:{'|'.join(mods)})$"]
        for k in lora:
            _warn(notes, f"model.lora_config.{k}", "ignored")
        model["lora"] = out


def _translate_data(data: Dict[str, Any], notes: List[str]) -> None:
    if "datasets_type" in data:
        data["dataset_type"] = data.pop("datasets_type")
    dl = data.pop("dataloader", None)
    if isinstance(dl, dict):
        if "type" in dl:
            data["dataloader_type"] = dl.pop("type")
        if "drop_last" in dl:
            data["drop_last"] = dl.pop("drop_last")
        if "num_workers" in dl:
            data["num_workers"] = dl.pop("num_workers")
        for k in dl:
            _warn(notes, f"data.dataloader.{k}", "ignored")
    for k in ("train_size", "rmpad", "rmpad_with_pos_ids", "mm_configs",
              "source_name"):
        if k in data:
            _warn(notes, f"data.{k}",
                  "no TPU counterpart (packing/steps derive elsewhere), ignored")
            data.pop(k)


def _translate_train(train: Dict[str, Any], notes: List[str]) -> None:
    acc = train.pop("accelerator", None)
    if isinstance(acc, dict):
        fsdp = acc.pop("fsdp_config", None) or {}
        offload = acc.pop("offload_config", None) or acc.pop("offload", None) or {}
        _pop_map(acc, train, {
            "dp_replicate_size": "data_parallel_replicate_size",
            "dp_shard_size": "data_parallel_shard_size",
            "tp_size": "tensor_parallel_size",
            "pp_size": "pipeline_parallel_size",
            "ep_size": "expert_parallel_size",
            "ulysses_size": "ulysses_parallel_size",
            "cp_size": "context_parallel_size",
            # reference async_ulysses engine -> the chunked a2a/compute
            # overlap pipeline (parallel/async_ulysses.py)
            "async_ulysses": "ulysses_async",
        }, "train.accelerator", notes)
        if isinstance(fsdp, dict):
            mode = fsdp.pop("fsdp_mode", None)
            if mode is not None:
                train["data_parallel_mode"] = "ddp" if mode == "ddp" else "fsdp"
            mp = fsdp.pop("mixed_precision", None)
            if isinstance(mp, dict):
                enable = mp.pop("enable", True)
                pdty = mp.pop("param_dtype", "bfloat16")
                train["bf16"] = bool(enable) and pdty == "bfloat16"
                rd = mp.pop("reduce_dtype", "float32")
                if rd != "float32":
                    _warn(notes, "…mixed_precision.reduce_dtype",
                          "grad reduction is float32 on TPU, ignored")
                for k in mp:
                    _warn(notes, f"…mixed_precision.{k}", "ignored")
            for k in fsdp:
                _warn(notes, f"train.accelerator.fsdp_config.{k}",
                      "GSPMD shards declaratively, ignored")
        if isinstance(offload, dict):
            if offload.pop("enable_activation", False):
                # activation offload rides the remat policy here
                train["gradient_checkpointing_policy"] = "offload"
            for k in offload:
                _warn(notes, f"train.accelerator.offload_config.{k}", "ignored")
    gc = train.pop("gradient_checkpointing", None)
    if isinstance(gc, dict):
        if "enable" in gc:
            train["enable_gradient_checkpointing"] = gc.pop("enable")
        for k in gc:
            _warn(notes, f"train.gradient_checkpointing.{k}",
                  "jax.checkpoint needs no reentrant/debug knobs, ignored")
    cm = train.pop("chunk_mbs_config", None)
    if isinstance(cm, dict):
        train["chunk_mbs"] = int(cm.get("chunk_mbs", 1)) if cm.get("enable") else 0
    opt = train.pop("optimizer", None)
    if isinstance(opt, dict):
        _pop_map(opt, train, {
            "type": "optimizer", "lr": "lr", "lr_min": "lr_min",
            "lr_warmup_ratio": "lr_warmup_ratio",
            "lr_decay_style": "lr_decay_style",
            "weight_decay": "weight_decay", "max_grad_norm": "max_grad_norm",
        }, "train.optimizer", notes)
    ckpt = train.pop("checkpoint", None)
    if isinstance(ckpt, dict):
        if ckpt.get("manager") == "dcp":
            ckpt["manager"] = "orbax"  # the TPU-native distributed manager
        _pop_map(ckpt, train, {
            "output_dir": "output_dir", "manager": "ckpt_manager",
            "save_steps": "save_steps", "save_hf_weights": "save_hf_weights",
            "save_async": "async_save",
            "load_checkpoint_path": "load_checkpoint_path",
            "auto_resume": "auto_resume",
        }, "train.checkpoint", notes)
    wandb = train.pop("wandb", None)
    if isinstance(wandb, dict):
        _pop_map(wandb, train, {
            "enable": "use_wandb", "project": "wandb_project",
            "name": "wandb_name",
        }, "train.wandb", notes)
    prof = train.pop("profile", None)
    if isinstance(prof, dict):
        _pop_map(prof, train, {
            "enable": "enable_profiling", "start_step": "profile_start_step",
            "end_step": "profile_end_step",
        }, "train.profile", notes)
    if "max_steps" in train:
        train["train_steps"] = train.pop("max_steps")
    if "broadcast_model_weights_from_rank0" in train:
        train["broadcast_weights_from_rank0"] = train.pop(
            "broadcast_model_weights_from_rank0"
        )
    for k in ("init_device", "empty_cache_steps", "bsz_warmup_ratio",
              "bsz_warmup_init_mbtoken", "channel_loss", "use_doptim",
              "broadcast_timeout", "use_rmpad", "load_balance",
              "calculate_per_token_loss"):
        if k in train:
            _warn(notes, f"train.{k}", "no TPU counterpart, ignored")
            train.pop(k)


def _translate_cross_section(data: Dict[str, Any], notes: List[str]) -> None:
    """Keys the reference places in a different section than we do."""
    train = data.get("train") or {}
    # dynamic batching is a data-pipeline concern here
    for k in ("dyn_bsz", "dyn_bsz_buffer_size"):
        if k in train:
            data.setdefault("data", {})[k] = train.pop(k)
    if train.pop("freeze_vit", False):
        # reference freezes the ViT via a trainer flag; here freezing is a
        # param-path mask on the model arguments
        data.setdefault("model", {}).setdefault("freeze_modules", []).append(
            "^vision_tower"
        )
    vit_lr = train.pop("vit_lr", None)
    if vit_lr is not None:
        base_lr = train.get("lr")
        if base_lr:
            train.setdefault("module_lr_scales", {})["^vision_tower"] = (
                float(vit_lr) / float(base_lr)
            )
        else:
            _warn(notes, "train.vit_lr",
                  "needs train.optimizer.lr to derive a scale, ignored")
    dpo = data.pop("dpo_config", None)
    if isinstance(dpo, dict):
        if "beta" in dpo:
            data.setdefault("train", {})["dpo_beta"] = dpo.pop("beta")
        for k in dpo:
            _warn(notes, f"dpo_config.{k}", "only sigmoid DPO here, ignored")
    for k in ("sources", "names"):
        if k in data:
            _warn(notes, k,
                  "data-mixture recipe block (fed to the dataset builder in "
                  "the reference), not a trainer argument — ignored")
            data.pop(k)


def _is_reference_schema(data: Dict[str, Any]) -> bool:
    """Marker detection BEFORE translation: any structurally reference-only
    block makes the whole file reference-schema (then unknown keys downgrade
    to warnings — the reference surface is larger than what maps to TPU)."""
    train = data.get("train") or {}
    model = data.get("model") or {}
    d = data.get("data") or {}
    return bool(
        isinstance(train.get("accelerator"), dict)
        or isinstance(train.get("optimizer"), dict)
        or isinstance(train.get("checkpoint"), dict)
        or isinstance(train.get("gradient_checkpointing"), dict)
        or isinstance(train.get("wandb"), dict)
        or isinstance(train.get("profile"), dict)
        or "lora_config" in model
        or any(k in _OPS_IMPL_MAP for k in (model.get("ops_implementation") or {}))
        or isinstance(d.get("dataloader"), dict)
        or "datasets_type" in d
        or "dpo_config" in data
        or "sources" in data
    )


def translate_reference_schema(
    data: Dict[str, Any],
) -> Tuple[Dict[str, Any], List[str], bool]:
    """Rewrite reference-schema blocks in a parsed YAML dict (in place) to the
    native flat schema; returns (data, notes, is_reference). Native-schema
    files pass through untouched with is_reference=False."""
    is_reference = _is_reference_schema(data)
    notes: List[str] = []
    if not is_reference:
        # native-schema file: zero mutation — a native flat key that happens
        # to collide with a reference block name (e.g. a scalar
        # train.optimizer) must never be eaten by the translator
        return data, notes, False
    if isinstance(data.get("model"), dict):
        _translate_model(data["model"], notes)
    if isinstance(data.get("data"), dict):
        _translate_data(data["data"], notes)
    if isinstance(data.get("train"), dict):
        _translate_train(data["train"], notes)
    _translate_cross_section(data, notes)
    for note in notes:
        logger.warning_rank0("reference-config: %s", note)
    if notes:
        logger.info_rank0(
            "reference-config: translated %d keys without TPU counterparts",
            len(notes),
        )
    return data, notes, is_reference
