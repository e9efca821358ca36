"""One train step of the port's model over a mesh of gloo processes (the
FSDP2 plan, Ulysses, ring attention, expert parallelism and the step's
reductions, ``veomni_tpu_torch/parallel/*``, ``train/train_step.py``)
against the JAX package at the same layout, on the CPU.

The mirror of ``tests/test_parallel_equivalence.py``: the dense and MoE
Qwen3 toys (2 layers, width 64, f32) with the JAX weights carried over, one
[8, 64] batch of two packed segments a row; each rank takes its dp rows and
its sp chunk. Loss within rtol 2e-5 and grad norm within rtol 2e-4 of the
JAX step at the same mesh, the JAX side on the conftest's virtual CPU
devices: on a world of 4, FSDP 4, DDP, HSDP 2x2, ulysses 2, cp 2 and
ulysses 2 x cp 2 (dense), (sp, ep) in {1,2}^2 (MoE) and EP at
``moe_capacity_factor`` 0.5 (which drops): the mesh-mean
``moe_dropped_frac`` equal to the reference's; at 2.0, where ep 2 cannot
drop, the dropless step bit for bit and 0; dropless EP also equal to the
port's single-process MoE. On a world of 2, FSDP 2 against JAX on 2
devices, ulysses 2 and ep 2 against the world-4 step, and each step's
collective census (bytes by kind) equal to the bytes
``observability/comm.py::plan_step_bytes`` reckons from the plan and the
shapes, with ``comm_est_frac`` above 0. Each world runs once for its file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from veomni_tpu.models import build_foundation_model
from veomni_tpu.models.config import TransformerConfig as JConfig
from veomni_tpu_torch.models import Transformer, TransformerConfig
from veomni_tpu_torch.models.jax_weights import load_jax_params
from veomni_tpu_torch.parallel.launch import run_ranks

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)
from torch_parallel_fixtures import save_tree

TESTS = os.path.dirname(os.path.abspath(__file__))
ENV = {"PYTHONPATH": os.pathsep.join([TESTS, os.path.dirname(TESTS)])}
TOY = dict(model_type="qwen3", vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
           qk_norm=True)
MOE = dict(TOY, model_type="qwen3_moe", num_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=64)
MODELS = {"dense": TOY, "moe": MOE}
WORLD4 = {
    "dense-fsdp4": ("dense", dict(dp_shard_size=4), {}),
    "dense-ddp": ("dense", dict(dp_replicate_size=-1, dp_shard_size=1), {}),
    "dense-hsdp2x2": ("dense", dict(dp_replicate_size=2, dp_shard_size=2), {}),
    "dense-ulysses2": ("dense", dict(ulysses_size=2, dp_shard_size=2), {}),
    "dense-cp2": ("dense", dict(cp_size=2, dp_shard_size=2), {}),
    "dense-ulysses2-cp2": ("dense", dict(ulysses_size=2, cp_size=2, dp_shard_size=1), {}),
    "moe-fsdp4": ("moe", dict(dp_shard_size=4), {}),
    "moe-ulysses2": ("moe", dict(ulysses_size=2, dp_shard_size=2), {}),
    "moe-ep2": ("moe", dict(ep_size=2, dp_shard_size=4), {}),
    "moe-ulysses2-ep2": ("moe", dict(ulysses_size=2, ep_size=2, dp_shard_size=2), {}),
    "moe-ep2-capacity2": ("moe", dict(ep_size=2, dp_shard_size=4),
                          {"moe_capacity_factor": 2.0}),
    "moe-ep2-capacity0.5": ("moe", dict(ep_size=2, dp_shard_size=4),
                            {"moe_capacity_factor": 0.5}),
}
WORLD2 = {
    "dense-fsdp2": ("dense", dict(dp_shard_size=2), {}),
    "dense-ulysses2": ("dense", dict(ulysses_size=2, dp_shard_size=1), {}),
    "moe-ep2": ("moe", dict(ep_size=2, dp_shard_size=2), {}),
}
# two steps at FSDP 2 of a LoRA model (AdamW on the adapters) and of the
# full model under the whole-leaf optimizers: name -> (model, optimizer, lora)
WORLD2_TRAIN = {
    "dense-fsdp2-lora": ("dense", "adamw", True),
    "dense-fsdp2-muon": ("dense", "muon", False),
    "dense-fsdp2-adafactor": ("dense", "adafactor", False),
}


def batch(bsz=8, seq=64, vocab=256, seed=0):
    """``tests/test_parallel_equivalence.py::_batch``: two packed segments a row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (bsz, seq))
    seg = np.ones((bsz, seq), np.int32)
    seg[:, seq // 2:] = 2
    pos = np.concatenate([np.arange(seq // 2), np.arange(seq - seq // 2)])
    return {"input_ids": ids.astype(np.int32), "labels": ids.astype(np.int32),
            "position_ids": np.broadcast_to(pos, (bsz, seq)).astype(np.int32).copy(),
            "segment_ids": seg}


def jax_step(kind, mesh, overrides, devices):
    """(loss, grad norm, moe_dropped_frac) of the JAX step at ``mesh``."""
    from veomni_tpu.parallel import init_parallel_state, use_parallel_state
    from veomni_tpu.parallel.parallel_state import destroy_parallel_state

    cfg = JConfig(**{**MODELS[kind], **overrides, "dtype": jnp.float32})
    destroy_parallel_state()
    ps = init_parallel_state(devices=jax.devices()[:devices], **mesh)
    model = build_foundation_model(config=cfg)
    try:
        with use_parallel_state(ps):
            params = model.init(jax.random.PRNGKey(0))
            params = jax.jit(lambda p: p, out_shardings=model.get_parallel_plan().resolve(
                params, ps))(params)
            b = {k: jax.device_put(jnp.asarray(v), ps.batch_sharding())
                 for k, v in batch().items()}

            def norm_loss(p, b):
                loss_sum, metrics = model.loss_fn(p, b)
                return loss_sum / jnp.maximum(metrics["ntokens"], 1), metrics

            (loss, metrics), grads = jax.jit(jax.value_and_grad(norm_loss, has_aux=True))(
                params, b)
            return (float(loss), float(jax.jit(optax.global_norm)(grads)),
                    float(metrics.get("moe_dropped_frac", 0.0)))
    finally:
        destroy_parallel_state()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("model")
    models = {}
    for kind, kw in MODELS.items():
        params = build_foundation_model(config=JConfig(**kw, dtype=jnp.float32)).init(
            jax.random.PRNGKey(0))
        save_tree(str(path / f"{kind}.npz"), jax.tree.map(np.asarray, params))
        models[kind] = {"cfg": dict(kw), "params": str(path / f"{kind}.npz"),
                        "tree": jax.tree.map(np.asarray, params)}
    save_tree(str(path / "batch.npz"), batch())
    from veomni_tpu.lora import LoraConfig, init_lora_params

    adapters = init_lora_params(jax.random.PRNGKey(1), models["dense"]["tree"],
                                LoraConfig(rank=4, alpha=8))
    save_tree(str(path / "adapters.npz"), jax.tree.map(np.asarray, adapters))
    return path, models


def run_world(inputs, world, layouts, census=False, train_layouts=None):
    path, models = inputs
    return run_ranks(world, "torch_parallel_fixtures:model_world", {
        "models": {k: {"cfg": m["cfg"], "params": m["params"]} for k, m in models.items()},
        "batch": str(path / "batch.npz"), "census": census,
        "adapters": str(path / "adapters.npz"),
        "layouts": {name: {"model": kind, "mesh": mesh, "cfg": cfg}
                    for name, (kind, mesh, cfg) in layouts.items()},
        "train_layouts": {name: {"model": kind, "mesh": dict(dp_shard_size=world),
                                 "optimizer": opt, "lora": lora}
                          for name, (kind, opt, lora) in (train_layouts or {}).items()}},
        env=ENV, timeout=600)


@pytest.fixture(scope="module")
def world4(inputs):
    return run_world(inputs, 4, WORLD4)


@pytest.fixture(scope="module")
def world2(inputs):
    return run_world(inputs, 2, WORLD2, census=True, train_layouts=WORLD2_TRAIN)


def check_against_jax(ranks, name, layouts, devices):
    kind, mesh, overrides = layouts[name]
    loss, gnorm, dropped = jax_step(kind, mesh, overrides, devices)
    got = ranks[0][name]
    step_keys = ("loss", "grad_norm", "moe_aux_loss", "moe_dropped_frac", "ntokens")
    for r in ranks[1:]:  # every rank reports the global step
        assert {k: r[name][k] for k in step_keys} == {k: got[k] for k in step_keys}
    np.testing.assert_allclose(got["loss"], loss, rtol=2e-5, err_msg="loss")
    np.testing.assert_allclose(got["grad_norm"], gnorm, rtol=2e-4, err_msg="grad norm")
    np.testing.assert_allclose(got["moe_dropped_frac"], dropped, rtol=1e-6, atol=1e-7)
    return got


@pytest.mark.parametrize("name", list(WORLD4))
def test_world4_step_matches_jax_at_the_same_layout(world4, name):
    if name == "moe-ep2-capacity2":
        # C = cf * t * k / ep >= t * k: no assignment can drop, in the
        # reference as here, so the step is the dropless one, bit for bit
        got, dropless = world4[0][name], world4[0]["moe-ep2"]
        assert got["moe_dropped_frac"] == 0.0
        assert (got["loss"], got["grad_norm"]) == (dropless["loss"], dropless["grad_norm"])
        return
    got = check_against_jax(world4, name, WORLD4, 4)
    if name == "moe-ep2-capacity0.5":
        assert got["moe_dropped_frac"] > 0  # the case drops assignments


def test_dropless_ep_equals_the_single_process_moe(world4, inputs):
    _, models = inputs
    model = Transformer(TransformerConfig(**MOE, dtype=torch.float32), None, device="cpu")
    load_jax_params(model, models["moe"]["tree"])
    loss_sum, metrics = model.loss_fn({k: torch.from_numpy(v) for k, v in batch().items()})
    loss = loss_sum / metrics["ntokens"]
    loss.backward()
    gnorm = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
    for name in ("moe-ep2", "moe-ulysses2-ep2", "moe-ep2-capacity2"):
        got = world4[0][name]
        np.testing.assert_allclose(got["loss"], loss.item(), rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], float(gnorm), rtol=2e-4)
        np.testing.assert_allclose(got["moe_aux_loss"], metrics["moe_aux_loss"].item(),
                                   rtol=2e-5)


@pytest.mark.parametrize("name", list(WORLD2))
def test_world2_step_matches_jax_and_its_census_the_plan(world2, world4, name):
    if name == "dense-fsdp2":  # FSDP at 2, against JAX on 2 devices
        got = check_against_jax(world2, name, WORLD2, 2)
    else:  # held to the JAX package at world 4 above: the same global step
        got, same = world2[0][name], world4[0][name.split("-")[0] + "-fsdp4"]
        np.testing.assert_allclose(got["loss"], same["loss"], rtol=2e-5)
        np.testing.assert_allclose(got["grad_norm"], same["grad_norm"], rtol=2e-4)
    for r in world2:
        assert r[name]["census"] == r[name]["plan"], (r[name]["census"], r[name]["plan"])
        assert r[name]["comm_est_frac"] > 0
    kinds = set(got["census"])
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds
    assert ("all-to-all" in kinds) == (name != "dense-fsdp2")


def jax_two_steps(inputs, kind, optimizer, lora):
    """(losses, grad norms) of two steps (lr 1e-2) of the JAX package at
    FSDP 2 on 2 devices: the LoRA adapters under AdamW, or the full model
    under ``optimizer``."""
    from veomni_tpu.lora import apply_lora_to_loss_fn
    from veomni_tpu.optim import build_optimizer as j_build_optimizer
    from veomni_tpu.parallel import init_parallel_state, use_parallel_state
    from veomni_tpu.parallel.parallel_state import destroy_parallel_state

    path, models = inputs
    cfg = JConfig(**{**MODELS[kind], "dtype": jnp.float32})
    destroy_parallel_state()
    ps = init_parallel_state(devices=jax.devices()[:2], dp_shard_size=2)
    model = build_foundation_model(config=cfg)
    try:
        with use_parallel_state(ps):
            params = jax.jit(lambda p: p, out_shardings=model.get_parallel_plan().resolve(
                jax.tree.map(jnp.asarray, models[kind]["tree"]), ps))(
                jax.tree.map(jnp.asarray, models[kind]["tree"]))
            b = {k: jax.device_put(jnp.asarray(v), ps.batch_sharding())
                 for k, v in batch().items()}
            loss_fn = model.loss_fn
            if lora:
                from torch_parallel_fixtures import load_tree

                loss_fn = apply_lora_to_loss_fn(model.loss_fn, params)
                params = jax.tree.map(jnp.asarray, load_tree(str(path / "adapters.npz")))
            tx = j_build_optimizer(params, optimizer=optimizer, lr=1e-2)
            opt_state = tx.init(params)

            @jax.jit
            def step(p, s):
                def norm_loss(q):
                    loss_sum, metrics = loss_fn(q, b)
                    return loss_sum / jnp.maximum(metrics["ntokens"], 1)

                loss, grads = jax.value_and_grad(norm_loss)(p)
                updates, s = tx.update(grads, s, p)
                return optax.apply_updates(p, updates), s, loss, optax.global_norm(grads)

            losses, norms = [], []
            for _ in range(2):
                params, opt_state, loss, gn = step(params, opt_state)
                losses.append(float(loss))
                norms.append(float(gn))
            return losses, norms
    finally:
        destroy_parallel_state()


@pytest.mark.parametrize("name", list(WORLD2_TRAIN))
def test_world2_lora_and_whole_leaf_optimizers_match_jax_and_shard_their_memory(
        world2, inputs, name):
    """Two steps at FSDP 2 against the JAX package at the same mesh (loss
    rtol 2e-5, grad norm 2e-4); each rank holds at most 0.55 of the whole
    frozen base (LoRA) or of the whole optimizer state (Muon, Adafactor);
    the state after step 1 saved and restored gives step 2 bit for bit."""
    kind, optimizer, lora = WORLD2_TRAIN[name]
    losses, norms = jax_two_steps(inputs, kind, optimizer, lora)
    for r in world2:
        got = r[name]
        np.testing.assert_allclose(got["loss"], losses, rtol=2e-5, err_msg="loss")
        np.testing.assert_allclose(got["grad_norm"], norms, rtol=2e-4, err_msg="grad norm")
        local, whole = got["base_bytes" if lora else "state_bytes"]
        assert 0 < local <= 0.55 * whole, (local, whole)
        assert got["resumed_loss"] == got["loss"][1] and got["resumed_digest"]
    assert world2[0][name]["loss"] == world2[1][name]["loss"]
