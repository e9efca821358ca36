"""Rank targets of the port's parallel-layer tests
(``tests/test_torch_parallel_*.py``).

Each ``*_world`` function runs inside one rank of a gloo world started by
``veomni_tpu_torch.parallel.launch.run_ranks`` and imports torch and the
port only (no JAX): the tests compute the JAX references in the pytest
process and hand the inputs over as ``.npz`` files. A rank writes its
tensors to ``<out>/rank<r>-<case>.npz`` and returns its scalars as JSON.
Several layouts run in one world (one ``init_parallel_state`` each), so
each world size is started about once.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch


def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def save_tree(path: str, tree: Dict[str, Any]) -> None:
    """A nested dict of arrays as one ``.npz`` ('/'-joined keys)."""
    np.savez(path, **_flat(tree))


def load_tree(path: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return tree


# --------------------------------------------------------------- attention
def attention_world(rank: int, world: int, payload: Dict[str, Any]):
    """Sequence-parallel attention of every case in ``payload["npz"]`` at each
    layout of ``payload["layouts"]`` ({name: ulysses, cp, async chunks}):
    this rank's output chunk and its q/k/v (and sinks) gradients under the
    cotangent ``dout``, in ``<out>/rank<r>-<layout>-<case>.npz``."""
    from veomni_tpu_torch.ops.attention import _attention_xla
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state, init_parallel_state
    from veomni_tpu_torch.parallel.sequence_parallel import sp_attention, sp_slice

    cases = load_tree(payload["npz"])
    out = {}
    for lay_name, lay in payload["layouts"].items():
        destroy_parallel_state()
        ps = init_parallel_state(ulysses_size=lay["ulysses"], cp_size=lay["cp"],
                                 dp_shard_size=world // (lay["ulysses"] * lay["cp"]))
        for name, c in cases.items():
            t = {k: torch.from_numpy(v) for k, v in c.items()}
            q, k, v = (sp_slice(t[n], ps).clone().requires_grad_(True) for n in ("q", "k", "v"))
            seg = sp_slice(t["seg"], ps) if "seg" in t else None
            sinks = t["sinks"].clone().requires_grad_(True) if "sinks" in t else None
            kw = dict(causal=bool(c["causal"]), sliding_window=int(c["window"]) or None,
                      sinks=sinks)
            got = sp_attention(_attention_xla, q, k, v, seg, ps,
                               async_chunks=lay.get("chunks") or None, **kw)
            got.backward(sp_slice(t["dout"], ps))
            res = {"out": got.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
            if sinks is not None:
                res["dsinks"] = sinks.grad
            np.savez(os.path.join(payload["out"], f"rank{rank}-{lay_name}-{name}.npz"),
                     **{n: x.numpy() for n, x in res.items()})
        out[lay_name] = ps.sp_rank()
    destroy_parallel_state()
    return out


# ------------------------------------------------------------------- model
def _rank_batch(batch: Dict[str, np.ndarray], ps) -> Dict[str, torch.Tensor]:
    """This rank's rows (its dp index, a contiguous block as the data
    loader's dp shard) and sequence chunk (its sp index, by the port's
    ``sp_slice`` as the trainer's ``_ship_batch`` cuts it) of a global
    [B, S] batch, with a leading micro-batch dim of 1."""
    from veomni_tpu_torch.parallel.sequence_parallel import sp_slice

    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        rows = t.shape[0] // ps.dp_size
        t = t[ps.data_parallel_index() * rows:(ps.data_parallel_index() + 1) * rows]
        out[k] = sp_slice(t, ps, dim=t.ndim - 1)[None]
    return out


def model_world(rank: int, world: int, payload: Dict[str, Any]):
    """One train step (learning rate 0) of the port's model at each layout of
    ``payload["layouts"]`` ({name: {model, mesh, cfg overrides}}) from the
    JAX weights of ``payload["models"][model]``: {layout: {loss, grad_norm,
    moe_aux_loss, moe_dropped_frac, ntokens}}, with the collective census of
    the step, the plan's reckoning and a window's ``comm_est_frac`` when
    ``payload["census"]``."""
    from veomni_tpu_torch.models import Transformer, TransformerConfig
    from veomni_tpu_torch.models.jax_weights import load_jax_params
    from veomni_tpu_torch.observability.comm import get_comm_census, plan_step_bytes
    from veomni_tpu_torch.observability.cost import batch_bucket, instrument_site
    from veomni_tpu_torch.parallel import use_parallel_state
    from veomni_tpu_torch.parallel.parallel_plan import apply_parallel_plan
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state, init_parallel_state
    from veomni_tpu_torch.train import build_train_state, build_train_step

    batch = load_tree(payload["batch"])
    results = {}
    for name, layout in payload["layouts"].items():
        destroy_parallel_state()
        model_spec = payload["models"][layout["model"]]
        cfg = TransformerConfig(**{**model_spec["cfg"], **layout.get("cfg", {}),
                                   "dtype": torch.float32})
        ps = init_parallel_state(**layout["mesh"])
        with use_parallel_state(ps):
            model = Transformer(cfg, None, device="cpu")
            load_jax_params(model, load_tree(model_spec["params"]))
            plan = apply_parallel_plan(model, ps)
            opt = torch.optim.SGD(model.parameters(), lr=0.0)
            step = build_train_step(plan.entry(lambda m, b: m.loss_fn(b)), max_grad_norm=0.0,
                                    layout=plan)
            rank_batch = _rank_batch(batch, ps)
            if payload.get("census"):
                step = instrument_site(f"train_step_{name}", step,
                                       bucket_fn=lambda args: batch_bucket(args[1]))
            _, metrics = step(build_train_state(model, opt), rank_batch)
            res = {k: float(metrics[k]) for k in
                   ("loss", "grad_norm", "moe_aux_loss", "moe_dropped_frac", "ntokens")}
            if payload.get("census"):
                rec = get_comm_census().get(f"train_step_{name}", batch_bucket(rank_batch))
                a, b, s = rank_batch["input_ids"].shape
                res["census"] = rec.bytes_by_kind
                res["plan"] = plan_step_bytes(plan, a, b, s)
                res["comm_est_frac"] = _window_frac(f"train_step_{name}", step, model, opt,
                                                    rank_batch)
        results[name] = res
    for name, layout in payload.get("train_layouts", {}).items():
        destroy_parallel_state()
        ps = init_parallel_state(**layout["mesh"])
        with use_parallel_state(ps):
            results[name] = _two_steps(payload, layout, ps, _rank_batch(batch, ps))
    destroy_parallel_state()
    return results


def _local_bytes(tensors) -> int:
    return sum((t.to_local() if hasattr(t, "to_local") else t).numel() * t.element_size()
               for t in tensors if torch.is_tensor(t) and t.ndim)


def _build_step(payload, layout, ps):
    """(train state, step, layout, the frozen base's layout or None,
    optimizer) of one ``train_layouts`` entry, from the JAX weights (and
    adapters)."""
    from veomni_tpu_torch.lora import LoraAdapters, LoraConfig, apply_lora_to_loss_fn
    from veomni_tpu_torch.lora import init_lora_params
    from veomni_tpu_torch.models import Transformer, TransformerConfig
    from veomni_tpu_torch.models.jax_weights import load_jax_adapters, load_jax_params
    from veomni_tpu_torch.optim import build_optimizer
    from veomni_tpu_torch.optim.optimizer import split_mixed_groups
    from veomni_tpu_torch.parallel.parallel_plan import (
        ParallelPlan, apply_parallel_plan, lora_parallel_plan_rules, model_parallel_plan)
    from veomni_tpu_torch.train import build_train_state, build_train_step

    spec = payload["models"][layout["model"]]
    cfg = TransformerConfig(**{**spec["cfg"], "dtype": torch.float32})
    model = Transformer(cfg, None, device="cpu")
    load_jax_params(model, load_tree(spec["params"]))
    base = base_plan = None
    if layout.get("lora"):
        base = model.requires_grad_(False)
        model = init_lora_params(None, base, LoraConfig(rank=4, alpha=8))
        load_jax_adapters(model, load_tree(payload["adapters"]))
        base_plan = apply_parallel_plan(base, ps)
        plan = apply_parallel_plan(model, ps, model_parallel_plan(cfg).merge(
            ParallelPlan(rules=lora_parallel_plan_rules())))
        loss_fn = apply_lora_to_loss_fn(base_plan.entry(lambda m, b: m.loss_fn(b)), base)
    else:
        plan = apply_parallel_plan(model, ps)
        loss_fn = lambda m, b: m.loss_fn(b)  # noqa: E731
    opt = split_mixed_groups(build_optimizer(model, optimizer=layout.get("optimizer", "adamw"),
                                             lr=1e-2))
    if hasattr(opt, "leaves"):
        opt.layout = plan
    step = build_train_step(plan.entry(loss_fn), max_grad_norm=0.0, layout=plan,
                            scope=LoraAdapters.merged if base is not None else None)
    return build_train_state(model, opt), step, plan, base_plan, opt


def _two_steps(payload, layout, ps, batch):
    """Two steps (lr 1e-2) of a LoRA model (AdamW on the adapters) or of the
    full model under a whole-leaf optimizer, with each rank's resident bytes
    of the base's parameters and of the optimizer state beside the whole
    ones (world 1's), and the state after step 1 saved and restored into a
    fresh model and optimizer (the checkpointer's gather and cut) whose step
    2 must equal the straight one bit for bit."""
    from veomni_tpu_torch.checkpoint.checkpointer import load_state_into, snapshot_state

    state, step, plan, base_plan, opt = _build_step(payload, layout, ps)
    res = {"loss": [], "grad_norm": []}
    state, m = step(state, batch)
    res["loss"].append(float(m["loss"]))
    res["grad_norm"].append(float(m["grad_norm"]))
    saved = snapshot_state(state, plan)
    whole_state = [v for st in saved["optimizer"]["state"].values() for v in st.values()]
    local_state = [v for st in opt.state.values() for v in st.values()]
    res["state_bytes"] = [_local_bytes(local_state), _local_bytes(whole_state)]
    if base_plan is not None:
        res["base_bytes"] = [
            _local_bytes(base_plan.module.parameters()),
            sum(int(np.prod(r.full_shape)) * p.element_size() for p, r in base_plan.rules.items())]
    state, m = step(state, batch)
    res["loss"].append(float(m["loss"]))
    res["grad_norm"].append(float(m["grad_norm"]))
    fresh, fresh_step, fresh_plan, _, _ = _build_step(payload, layout, ps)
    load_state_into(fresh, saved, fresh_plan)
    fresh, m = fresh_step(fresh, batch)
    res["resumed_loss"] = float(m["loss"])
    res["resumed_digest"] = _param_digest(fresh.model) == _param_digest(state.model)
    return res


def _window_frac(site, step, model, opt, batch):
    """``comm_est_frac`` of a cost window over one more step."""
    from veomni_tpu_torch.observability.cost import CostWindow
    from veomni_tpu_torch.train import build_train_state

    window = CostWindow(sites=(site,))
    window.begin()
    step(build_train_state(model, opt), batch)
    return window.end().get("comm_est_frac", 0.0)


# ----------------------------------------------------------------- trainer
def trainer_args(run: Dict[str, Any]):
    """The port's ``VeOmniArguments`` of one trainer run: the reference e2e
    toy's model (or ``run["model"]``), pretokenized data from
    ``run["data"]``, sync saves, no export, CPU."""
    from veomni_tpu_torch.arguments import VeOmniArguments

    args = VeOmniArguments()
    args.model.config_overrides = dict(run["model"])
    args.data.train_path = run["data"]
    args.data.data_type = run.get("data_type", "pretokenized")
    args.data.max_seq_len = run.get("seq", 64)
    args.data.samples_per_micro_batch = 1
    for k, v in run.get("data_args", {}).items():
        setattr(args.data, k, v)
    for k, v in run.get("model_args", {}).items():
        setattr(args.model, k, v)
    for k, v in {"platform": "cpu", "output_dir": run["out"], "lr": 1e-3, "bf16": False,
                 "async_save": False, "save_hf_weights": False, "log_steps": 100,
                 "prefetch_depth": 0, "micro_batch_size": 2, **run.get("train", {})}.items():
        setattr(args.train, k, v)
    return args


def _param_digest(model) -> str:
    import hashlib

    md = hashlib.md5()
    for name, p in sorted(model.named_parameters()):
        local = p.to_local() if hasattr(p, "to_local") else p
        md.update(name.encode())
        md.update(local.detach().contiguous().numpy().tobytes())
    return md.hexdigest()


def trainer_world(rank: int, world: int, payload: Dict[str, Any]):
    """Each run of ``payload["runs"]`` in turn through the port's trainer
    (``run["trainer"]`` "vlm": ``VLMTrainer``, "dpo": ``TextDPOTrainer``,
    "omni": ``OmniTrainer``) in
    this world: {run name:
    {losses, grad_norms, digest, dp_rank, dp_size, first step}}; a run
    resumes from its output directory like a restart, and one with
    ``stop_at`` stops after that step."""
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import OmniTrainer, TextDPOTrainer, TextTrainer, VLMTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback

    out = {}
    for name, run in payload["runs"].items():
        destroy_parallel_state()
        seen: Dict[str, Any] = {"losses": [], "grad_norms": []}

        class Capture(Callback):
            def on_train_begin(self, trainer, state):
                seen["first_step"] = state.global_step
                seen["dp_rank"] = trainer.dataloader.dp_rank
                seen["dp_size"] = trainer.dataloader.dp_size

            def on_step_end(self, trainer, state):
                m = state.metrics
                seen["losses"].append(float(m["loss"]))
                seen["grad_norms"].append(float(m["grad_norm"]))
                if state.global_step == run.get("stop_at"):
                    state.should_stop = True  # a preempted run (after its save)

        args = trainer_args(run)
        args.train.log_steps = 1
        trainer = {"vlm": VLMTrainer, "dpo": TextDPOTrainer, "omni": OmniTrainer}.get(
            run.get("trainer"), TextTrainer)(args)
        trainer.callbacks.append(Capture())
        trainer.train()
        trainer.checkpointer.close()
        seen["digest"] = _param_digest(trainer.train_state.model)
        seen["consumed_tokens"] = trainer.meter.consumed_tokens
        seen["world"] = trainer.parallel_state.world_size
        out[name] = seen
    destroy_parallel_state()
    return out



def ep_load_world(rank: int, world: int, payload: Dict[str, Any]):
    """The trainer's HF load at ep ``world`` (``tests/test_multihost.py``'s
    EP-sliced load): the checkpoint tensors this rank read, and whether each
    of its experts' rows equals the tensor on disk bit for bit."""
    from veomni_tpu_torch.models import hf_io
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import TextTrainer

    read = []
    get_tensor = hf_io.SafetensorsFile.get_tensor

    def counting(self, name):
        read.append(name)
        return get_tensor(self, name)

    args = trainer_args({"model": {}, "data": payload["data"], "out": payload["out"],
                         "train": {"train_steps": 1, "expert_parallel_size": world}})
    args.model.config_path = args.model.model_path = payload["ckpt"]
    hf_io.SafetensorsFile.get_tensor = counting
    try:
        trainer = TextTrainer(args)
    finally:
        hf_io.SafetensorsFile.get_tensor = get_tensor
    disk = hf_io.LazyHFTensors(payload["ckpt"])
    e_loc = trainer.model.config.num_experts // world
    match = True
    for i, layer in enumerate(trainer.train_state.model.layers):
        for name in ("gate_proj", "up_proj", "down_proj"):
            local = getattr(layer.experts, name).detach()
            for j in range(e_loc):
                want = disk.read(f"model.layers.{i}.mlp.experts.{rank * e_loc + j}.{name}.weight")
                match = match and torch.equal(local[j], want.t().to(local.dtype))
    destroy_parallel_state()
    return {"read": sorted(read), "match": bool(match), "experts": [rank * e_loc, (rank + 1) * e_loc]}
