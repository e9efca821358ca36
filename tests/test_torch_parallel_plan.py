"""The port's parallel plan and mesh (``veomni_tpu_torch/parallel/
{parallel_plan,parallel_state}.py``) against the JAX package's, on the
CPU, without processes.

* ``spec_for`` equals the JAX plan's on every parameter path of the dense
  Qwen3 toy, the Qwen3-MoE toy, its LoRA adapter tree (the plan merged with
  the LoRA rules) and the Qwen2.5-VL toy, at meshes that shard over fsdp,
  ep, ulysses and cp (the JAX meshes on the conftest's 4 virtual devices).
* The port's per-layer parameters take the kind their reference leaf's
  spec gives (FSDP on the spec's dim, experts on ep and ep_fsdp,
  replicated): ``param_rules`` on the port's modules.
* ``init_parallel_state``'s size inference and errors, the flattened axis
  groups, ``data_parallel_index`` (the dp position, not the rank) and
  ``sp_rank`` (cp outer) over a laid-out mesh, and ``without_sp``.
"""

import jax
import numpy as np
import pytest
import torch

from veomni_tpu.models import build_foundation_model as j_build
from veomni_tpu.models.auto import build_config as j_build_config
from veomni_tpu.parallel import init_parallel_state as j_init
from veomni_tpu.parallel.parallel_plan import ParallelPlan as JPlan
from veomni_tpu.parallel.parallel_plan import param_path_str
from veomni_tpu_torch.models.auto import build_config
from veomni_tpu_torch.models.jax_weights import load_jax_params
from veomni_tpu_torch.models.auto import FoundationModel
from veomni_tpu_torch.parallel.parallel_plan import (
    ParallelPlan,
    lora_parallel_plan_rules,
    model_parallel_plan,
    param_rules,
)
from veomni_tpu_torch.parallel.parallel_state import (
    ParallelState,
    destroy_parallel_state,
    init_parallel_state,
)

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

DENSE = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16, qk_norm=True,
             dtype="float32")
MOE = dict(DENSE, num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64)
VL_TEXT = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
               image_token_id=9, video_token_id=10, vision_start_token_id=8, dtype="float32")
VL_VISION = dict(depth=2, hidden_size=32, intermediate_size=48, num_heads=2, patch_size=2,
                 spatial_merge_size=2, window_size=8, fullatt_block_indexes=[1],
                 out_hidden_size=64)
# (ep, fsdp, ulysses, cp) over the 4 devices
MESHES = [dict(dp_shard_size=4), dict(ep_size=2, dp_shard_size=4),
          dict(ulysses_size=2, ep_size=2, dp_shard_size=2), dict(cp_size=2, dp_shard_size=2),
          dict(dp_replicate_size=2, dp_shard_size=2)]


def port_state(jstate) -> ParallelState:
    """The port's state at the JAX state's mesh (sizes only: spec_for needs no
    process group)."""
    mesh = tuple(jstate.mesh.shape[a] for a in jstate.mesh.axis_names)
    return ParallelState(pp_size=mesh[0], dp_replicate_size=mesh[1], ep_size=mesh[2],
                         fsdp_size=mesh[3], ulysses_size=mesh[4], cp_size=mesh[5],
                         tp_size=mesh[6], mesh=mesh)


def normalize(spec, ndim):
    """A JAX PartitionSpec as the port's per-dim tuple of axis tuples."""
    out = [None if a is None else ((a,) if isinstance(a, str) else tuple(a)) for a in spec]
    return tuple(out) + (None,) * (ndim - len(out))


def jax_tree(model_type, kw, lora=False):
    cfg = j_build_config(model_type, **kw)
    model = j_build(config=cfg)
    params = model.init(jax.random.PRNGKey(0))
    plan = model.get_parallel_plan()
    if lora:
        from veomni_tpu.lora import LoraConfig, init_lora_params

        params = init_lora_params(jax.random.PRNGKey(1), params, LoraConfig(
            rank=4, target_patterns=[r"q_proj", r"experts\.(gate|down)_proj"]))
        plan = plan.merge(JPlan(rules=lora_parallel_plan_rules()))
    return cfg, params, plan


@pytest.mark.parametrize("case", ["dense", "moe", "moe-lora", "qwen2_5_vl"])
def test_spec_for_equals_the_jax_plan_on_every_path(case):
    model_type, kw = {"dense": ("qwen3", DENSE), "moe": ("qwen3_moe", MOE),
                      "moe-lora": ("qwen3_moe", MOE),
                      "qwen2_5_vl": ("qwen2_5_vl", dict(VL_TEXT, vision=VL_VISION))}[case]
    jcfg, params, jplan = jax_tree(model_type, kw, lora=case.endswith("lora"))
    plan = model_parallel_plan(build_config(model_type, **kw))
    if case.endswith("lora"):
        plan = plan.merge(ParallelPlan(rules=lora_parallel_plan_rules()))
    assert plan.rules == jplan.rules and plan.stacked_layer_prefixes == jplan.stacked_layer_prefixes
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    checked = 0
    for mesh in MESHES:
        jstate = j_init(**mesh)
        state = port_state(jstate)
        for path, leaf in leaves:
            p = param_path_str(path)
            want = normalize(jplan.spec_for(p, leaf.shape, jstate), leaf.ndim)
            assert plan.spec_for(p, leaf.shape, state) == want, (mesh, p, leaf.shape)
            checked += 1
    assert checked == len(MESHES) * len(leaves) > 0


@pytest.mark.parametrize("case", ["dense", "moe"])
def test_port_parameters_take_their_leaf_kind(case):
    """Each of the port's per-layer parameters is FSDP-sharded on the dim
    its leaf's spec shards (the stacked dim dropped), an expert on ep (and
    ep_fsdp where its feature dim divides), else replicated."""
    model_type, kw = ("qwen3", DENSE) if case == "dense" else ("qwen3_moe", MOE)
    jcfg, params, jplan = jax_tree(model_type, kw)
    module = FoundationModel(build_config(model_type, **kw)).init(
        torch.Generator().manual_seed(0), device="cpu")
    load_jax_params(module, jax.tree.map(np.asarray, params))
    specs = {param_path_str(path): (leaf.shape, path)
             for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    for mesh in MESHES:
        jstate = j_init(**mesh)
        state = port_state(jstate)
        rules = param_rules(module, model_parallel_plan(module.cfg), state)
        assert len(rules) == len(list(module.parameters()))
        for rule in rules.values():
            shape, _ = specs[rule.path]
            stacked = rule.path.startswith("layers.")
            spec = normalize(jplan.spec_for(rule.path, shape, jstate), len(shape))
            per_layer = spec[1:] if stacked else spec
            if rule.kind == "fsdp":
                assert per_layer[rule.dim] == state.fsdp_axes, (mesh, rule)
                assert all(a is None for d, a in enumerate(per_layer) if d != rule.dim)
            elif rule.kind == "expert":
                assert per_layer[0] == ("ep",) and rule.ep_dim == 0, (mesh, rule)
                assert (rule.feature_dim is not None) == (per_layer[1] is not None)
            else:
                assert all(a is None for a in per_layer), (mesh, rule)


def test_mesh_sizes_groups_and_indices():
    # size inference and the reference's errors, on the one-process world
    try:
        ps = init_parallel_state(dp_shard_size=-1)
        assert (ps.world_size, ps.dp_size, ps.sp_size, ps.groups) == (1, 1, 1, {})
        with pytest.raises(ValueError, match="not divisible"):
            init_parallel_state(ulysses_size=2)
        with pytest.raises(ValueError, match="device count"):
            init_parallel_state(dp_shard_size=4)
        with pytest.raises(ValueError, match="must divide"):
            init_parallel_state(ep_size=2, dp_shard_size=1)
        with pytest.raises(ValueError, match="at most one"):
            init_parallel_state(dp_replicate_size=-1, dp_shard_size=-1)
    finally:
        destroy_parallel_state()
    # a laid-out mesh of 16 ranks: dp_replicate 2, ep 2, fsdp 1, ulysses 2, cp 2
    mesh = (1, 2, 2, 1, 2, 2, 1)
    for rank in range(16):
        st = ParallelState(dp_replicate_size=2, ep_size=2, ulysses_size=2, cp_size=2,
                           rank=rank, mesh=mesh)
        c = st.coords
        assert rank == ((c["dp_replicate"] * 2 + c["ep"]) * 2 + c["ulysses"]) * 2 + c["cp"]
        # the dp position: replicate major, then ep; the sp chunk: cp outer
        assert st.data_parallel_index() == c["dp_replicate"] * 2 + c["ep"]
        assert st.sp_rank() == c["cp"] * 2 + c["ulysses"]
        assert len(st.group_ranks(st.fsdp_axes)) == 8 and rank in st.group_ranks(st.sp_axes)
        assert st.group_ranks(st.dp_sp_axes) == list(range(16))
        assert st.group_ranks(st.ep_replicate_axes) == sorted(
            r for r in range(16) if r // 4 % 2 == c["ep"])
        no_sp = st.without_sp()
        assert (no_sp.sp_size, no_sp.sp_rank(), no_sp.world_size) == (1, 0, 16)
        assert no_sp.data_parallel_index() == st.data_parallel_index()


@pytest.mark.parametrize("family", ["qwen2_5_vl"])
def test_vlm_per_row_matches_packed_and_jax(family):
    """``tests/test_vlm_per_row.py``: the per-row patch budgets (a batch split
    over ranks; ``models/qwen2_5_vl.py::flatten_per_row_vision``) give the
    packed batch's loss, and the JAX package's per-row loss (rtol 1e-5).
    Qwen2-VL's per-row batches are held key by key to the reference's in
    ``tests/test_torch_multimodal.py``, and its per-row training in
    ``tests/test_torch_parallel_trainer.py`` runs through the same
    ``flatten_per_row_vision``."""
    import jax.numpy as jnp

    from veomni_tpu.data import multimodal as jmm
    from veomni_tpu.data.data_transform import build_data_transform as j_transform
    from veomni_tpu_torch.data import multimodal as tmm

    vision = VL_VISION if family == "qwen2_5_vl" else dict(
        depth=2, embed_dim=32, hidden_size=64, mlp_ratio=2, num_heads=2, patch_size=2,
        spatial_merge_size=2)
    kw = {**VL_TEXT, "vision": vision}
    jcfg, params, _ = jax_tree(family, kw)
    tcfg = build_config(family, **kw)
    module = FoundationModel(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    load_jax_params(module, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    transform = j_transform(family, tokenizer=None, vlm_config=jcfg, max_seq_len=64,
                            max_patches_per_sample=32, text_keys="text")
    samples = [transform({"input_ids": rng.integers(11, 256, int(rng.integers(8, 24))).tolist(),
                          "images": [rng.random((8 + 4 * (i % 2), 8, 3))]}) for i in range(4)]
    name = {"qwen2_vl": "Qwen2VLCollator", "qwen2_5_vl": "Qwen25VLCollator"}[family]
    jloss_fn = j_build(config=jcfg).family.loss_fn
    losses = {}
    for per_row in (False, True):
        got = getattr(tmm, name)(64, 4, tcfg, 128, per_row=per_row)(samples)
        with torch.no_grad():
            loss, metrics = module.loss_fn({k: torch.from_numpy(v) for k, v in got.items()})
        losses[per_row] = float(loss), float(metrics["ntokens"])
    jb = getattr(jmm, name)(64, 4, jcfg, 128, per_row=True)(samples)
    jl, jm = jloss_fn(params, jcfg, {k: jnp.asarray(v) for k, v in jb.items()})
    assert losses[True][1] == losses[False][1] == float(jm["ntokens"])
    np.testing.assert_allclose(losses[True][0], losses[False][0], rtol=1e-5)
    np.testing.assert_allclose(losses[True][0], float(jl), rtol=1e-5)
