"""The port's numerics observatory (``veomni_tpu_torch/observability/numerics.py``)
against the JAX one, on the CPU.

* ``tree_health``: the reference's tree at ``tests/test_torch_transformer.py``'s
  toy (4 layers) with seeded gradients and updates (numpy, seed 5) that carry
  a NaN in layer 2's ``q_proj`` gradient, an inf in the final ``norm``'s
  gradient and a NaN in one ``up_proj`` update: the port's document (from
  the per-layer parameters, stacked back) has the reference's group names,
  per-layer vectors and non-finite counts exactly, and every statistic
  within rtol 1e-5 (f32 sums in another order), at the default group cap
  and at a cap of 3 (coarsening into ``layers`` and ``...rest``); the
  provenance and the worst-layer gauges agree.
* The ``step.params`` nan drill through both trainers (the JAX
  ``TextTrainer`` and the port's, ``tests/test_e2e_training.py``'s toy,
  anomaly budget 1): each aborts and its post-mortem's ``first_nonfinite``
  names the same group, kind, layer and count.
* ``_diagnose_numerics`` after a step, under AdamW and Muon: parameters,
  the optimizer's moments and its update count bit-unchanged.
* Interval 2 and interval 0 over 6 steps: bit-equal losses and parameters,
  three health documents in the history, the gauges published.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from veomni_tpu.observability.numerics import NumericsMonitor as JMonitor
from veomni_tpu.observability.numerics import tree_health as j_tree_health
from veomni_tpu_torch.models.jax_weights import reference_leaves
from veomni_tpu_torch.observability.metrics import get_registry
from veomni_tpu_torch.observability.numerics import NumericsMonitor, tree_health
from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
from veomni_tpu_torch.trainer import TextTrainer
from veomni_tpu_torch.trainer.callbacks import Callback

from test_e2e_training import _make_args, _write_dummy_data
from test_torch_muon import _flatten
from test_torch_trainer import port_args, state_tensors
from test_torch_transformer import jax_and_torch_models
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    from veomni_tpu.resilience.faults import disarm_faults as j_disarm
    from veomni_tpu_torch.observability.numerics import set_active_monitor
    from veomni_tpu_torch.resilience.faults import disarm_faults

    disarm_faults()
    j_disarm()
    set_active_monitor(None)


def _port_values(model, tree):
    """The port's leaf values of a reference-layout tree: per-layer tensors
    for a stacked leaf."""
    flat = _flatten(tree)
    paths, values = [], []
    for path, params, stacked in reference_leaves(model):
        leaf = np.asarray(flat[path])
        paths.append(path)
        values.append([torch.from_numpy(np.array(x)) for x in leaf] if stacked
                      else torch.from_numpy(np.array(leaf)))
    return paths, values


@pytest.mark.parametrize("max_groups", [64, 3])
def test_tree_health_matches_jax(max_groups):
    _, params, model = jax_and_torch_models()
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, params)
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32),
                         params)
    updates = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-5).astype(np.float32),
                           params)
    grads["layers"]["q_proj"][2, 3, 4] = np.nan
    grads["norm"][7] = np.inf
    updates["layers"]["up_proj"][1, 0, 0] = np.nan
    ref = JMonitor._to_doc(j_tree_health(params, grads, updates, max_groups=max_groups))
    paths, p_vals = _port_values(model, params)
    _, g_vals = _port_values(model, grads)
    _, u_vals = _port_values(model, updates)
    got = NumericsMonitor._to_doc(tree_health(paths, p_vals, g_vals, u_vals,
                                              max_groups=max_groups))
    assert sorted(got) == sorted(ref)
    if max_groups == 3:
        assert "...rest" in got and "layers" in got
    for group, stats in ref.items():
        assert sorted(got[group]) == sorted(stats)
        for stat, want in stats.items():
            have = got[group][stat]
            assert isinstance(have, list) == isinstance(want, list), (group, stat)
            if stat.endswith("_nonfinite"):
                assert have == want, (group, stat)
            else:
                np.testing.assert_allclose(have, want, rtol=1e-5, err_msg=f"{group}.{stat}")
    assert NumericsMonitor.first_nonfinite(got) == JMonitor.first_nonfinite(ref)


class _Losses(Callback):
    def __init__(self):
        self.losses = {}

    def on_step_end(self, trainer, state):
        if state.synced:
            self.losses[state.global_step] = float(state.metrics["loss"]).hex()


def _drill(args, trainer_cls, configure):
    from veomni_tpu.resilience import AnomalyBudgetExceeded as JAbort
    from veomni_tpu_torch.resilience import AnomalyBudgetExceeded

    configure([{"point": "step.params", "mode": "nan", "hit": 3, "group": "layers.q_proj"}])
    args.train.train_steps = 6
    args.train.observability_numerics_interval = 100  # the tier armed, its cadence unused
    args.train.resilience_anomaly_budget = 1
    args.train.resilience_rollback_after = 10
    trainer = trainer_cls(args)
    with pytest.raises((AnomalyBudgetExceeded, JAbort)):
        trainer.train()
    trainer.checkpointer.close()
    with open(os.path.join(args.train.output_dir, "postmortem-0.json")) as f:
        return json.load(f)


def test_step_params_drill_names_the_same_group_in_both_trainers(tmp_path):
    from veomni_tpu.parallel.parallel_state import destroy_parallel_state as j_destroy
    from veomni_tpu.resilience.faults import configure_faults as j_configure
    from veomni_tpu.trainer import TextTrainer as JaxTextTrainer
    from veomni_tpu_torch.resilience.faults import configure_faults

    _write_dummy_data(tmp_path / "data.jsonl")
    ref = _drill(_make_args(tmp_path), JaxTextTrainer, j_configure)
    j_destroy()
    got = _drill(port_args(tmp_path), TextTrainer, configure_faults)
    destroy_parallel_state()
    want = ref["numerics"]["provenance"]["first_nonfinite"]
    assert want == {"group": "layers.q_proj", "kind": "param", "nonfinite_count": 1.0,
                    "layer": 0}
    assert got["numerics"]["provenance"]["first_nonfinite"] == want
    assert got["reason"] == "exception:AnomalyBudgetExceeded"
    evs = [e for e in got["events"] if e.get("kind") == "numerics.nonfinite"]
    assert evs and evs[0]["payload"]["group"] == "layers.q_proj"


@pytest.mark.parametrize("optimizer", ["adamw", "muon"])
def test_diagnosis_leaves_the_state_bit_unchanged(tmp_path, optimizer):
    from veomni_tpu_torch.resilience import SupervisorPolicy, TrainSupervisor
    from veomni_tpu_torch.trainer.callbacks import TrainerControlState

    _write_dummy_data(tmp_path / "data.jsonl")
    trainer = TextTrainer(port_args(tmp_path, train_steps=2, optimizer=optimizer))
    batch = trainer._ship_batch(next(iter(trainer.dataloader)))
    trainer.train_state, _ = trainer.train_step(trainer.train_state, batch)  # moments exist
    before = state_tensors(trainer)
    trainer._numerics = NumericsMonitor()
    trainer._supervisor = TrainSupervisor(SupervisorPolicy.from_train_args(trainer.args.train))
    ctl = TrainerControlState(train_steps=2)
    trainer._diagnose_numerics(ctl, batch)
    prov = trainer._numerics.snapshot()["provenance"]
    assert prov is not None and prov["first_nonfinite"] is None
    assert max(prov["groups"]["layers.q_proj"]["update_ratio"]) > 0  # an update was computed
    after = state_tensors(trainer)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    trainer.checkpointer.close()
    destroy_parallel_state()


def test_interval_two_and_zero_give_bit_equal_runs(tmp_path):
    _write_dummy_data(tmp_path / "data.jsonl")
    runs = {}
    for interval in (0, 2):
        trainer = TextTrainer(port_args(tmp_path, f"i{interval}", train_steps=6, log_steps=1,
                                        observability_numerics_interval=interval))
        rec = _Losses()
        trainer.callbacks.append(rec)
        trainer.train()
        runs[interval] = (rec.losses, state_tensors(trainer), trainer)
        trainer.checkpointer.close()
        destroy_parallel_state()
    assert runs[0][0] == runs[2][0] and len(runs[0][0]) == 6
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[2][1][k]), k
    mon = runs[2][2]._numerics
    hist = mon.snapshot()["history"]
    assert [h["step"] for h in hist] == [2, 4, 6]
    assert len(hist[0]["groups"]["layers.q_proj"]["grad_rms"]) == 2  # per layer
    names = [n for n, _ in get_registry().items_snapshot() if n.startswith("numerics.")]
    assert "numerics.layers.q_proj.update_ratio" in names
