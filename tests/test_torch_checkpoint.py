"""The port's checkpointer and the trainer's resilience paths, on the CPU.

Replays of the reference's assertions (``tests/test_resilience.py``) on the
port (``veomni_tpu_torch.checkpoint`` and ``.resilience``):

* the integrity manifest: ``write_manifest`` of the port and of the
  reference write byte-equal ``manifest.json`` files on the same tree, and
  ``verify_manifest`` gives both the same verdicts under truncation and bit
  flips (``:786``);
* the checkpointer: quarantine and multi-generation fallback (``:901``), a
  re-save superseding a quarantined step (``:948``) also after a failed
  quarantine rename (``:984``), the verify mode gating bit-flip detection
  (``:1031``), quarantined generations aging out (``:1067``), an async
  commit error surfaced and evicted (``:466``), the sidecars written before
  the payload commit (``:495``), crash debris removed at start-up, and a
  payload round trip that restores parameters, AdamW moments, step counts,
  ``num_updates`` and the train step bit for bit;
* the trainer: a NaN step skipped and counted (``:347``), rollback replaying
  bit-exact (``:362``), rollback without a checkpoint (``:396``), the anomaly
  budget (``:407``), checkpoint save and restore faults absorbed by retries
  (``:423``, ``:448``) and retry exhaustion (``:438``), the watchdog firing
  on a stalled loop (``:540``, with the ``step.delay`` point, the port having
  no prefetch thread), and the ``step.params`` drill planting a real NaN.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

from veomni_tpu_torch.arguments import VeOmniArguments
from veomni_tpu_torch.checkpoint import Checkpointer, build_checkpointer
from veomni_tpu_torch.optim import build_optimizer
from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
from veomni_tpu_torch.resilience import CheckpointCorruptError, integrity
from veomni_tpu_torch.resilience.faults import (
    InjectedFault,
    configure_faults,
    disarm_faults,
    fired_faults,
)
from veomni_tpu_torch.train import build_train_state

from test_resilience import DENSE_TOY, _corrupt_payload, _make_ckpt_tree, _write_data
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


@pytest.fixture(autouse=True)
def _disarm_fault_plan():
    yield
    disarm_faults()
    os.environ.pop("VEOMNI_FAULT_PLAN", None)
    destroy_parallel_state()


# --------------------------------------------------------------- manifest


def test_manifest_bytes_equal_reference(tmp_path):
    from veomni_tpu.resilience import integrity as j_integrity

    trees = {}
    for name in ("port", "ref"):
        step_dir = tmp_path / name / "global_step_3"
        _make_ckpt_tree(step_dir)
        trees[name] = step_dir
    topo = {"version": 1, "world_size": 1, "mesh": {"fsdp": 1}}
    integrity.write_manifest(str(trees["port"]), topology=topo)
    j_integrity.write_manifest(str(trees["ref"]), topology=topo)
    got = (trees["port"] / "manifest.json").read_bytes()
    assert got == (trees["ref"] / "manifest.json").read_bytes()
    assert integrity.read_topology(str(trees["port"])) == topo

    def verdicts(mod, step_dir):
        return {mode: [(p.path, p.kind) for p in mod.verify_manifest(str(step_dir), mode).problems]
                for mode in ("size", "full")}

    for op in ("bitflip", "truncate"):
        for name, mod in (("port", integrity), ("ref", j_integrity)):
            _corrupt_payload(str(trees[name]), op=op)
        assert verdicts(integrity, trees["port"]) == verdicts(j_integrity, trees["ref"])
    assert verdicts(integrity, trees["port"])["size"] == [
        (os.path.join("train_state", "arr0.bin"), "truncated")]


# ----------------------------------------------------------- checkpointer


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(64))
        self.m = nn.Parameter(torch.zeros(4, 8))


def tiny_state(value=0.0):
    model = Tiny()
    with torch.no_grad():
        model.w.fill_(value)
    return build_train_state(model, build_optimizer(model, lr=1e-2))


def train_tiny(state, steps):
    for _ in range(steps):
        loss = (state.model.w ** 2).sum() + (state.model.m.sin()).sum()
        loss.backward()
        state.optimizer.step()
        state.optimizer.zero_grad()
        state.step += 1
    return state


def set_w(state, value):
    with torch.no_grad():
        state.model.w.fill_(value)
    return state


def test_payload_round_trip_restores_everything(tmp_path):
    state = train_tiny(tiny_state(0.5), 3)
    ref = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    ref_opt = {i: {k: v.clone() for k, v in s.items()}
               for i, s in enumerate(state.optimizer.state.values())}
    ck = build_checkpointer(str(tmp_path / "ck"), async_save=True)
    ck.save(3, state, extra_state={"global_step": 3})
    train_tiny(state, 2)  # in-place updates after the async save returned
    ck.wait()
    fresh = tiny_state(9.0)
    restored, extra = ck.load(fresh)
    assert restored is fresh and extra["global_step"] == 3
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p, ref[n]), n
    for i, s in enumerate(fresh.optimizer.state.values()):
        for k, v in s.items():
            assert torch.equal(v, ref_opt[i][k]), (i, k)
    assert fresh.optimizer.num_updates == 3 and fresh.step == 3
    assert sorted(os.listdir(os.path.join(ck.ckpt_dir, "global_step_3", "train_state"))) == [
        "model.pt", "optimizer.pt"]
    ck.close()


def test_ckpt_quarantine_and_multi_generation_fallback(tmp_path):
    from veomni_tpu_torch.observability.metrics import get_registry

    reg = get_registry()
    q0 = reg.counter("integrity.ckpt_quarantined").value
    f0 = reg.counter("integrity.ckpt_fallbacks").value
    ck = build_checkpointer(str(tmp_path / "ck"), async_save=False, verify_mode="size")
    state = tiny_state()
    for step in (1, 2, 3):
        ck.save(step, set_w(state, float(step)), extra_state={"global_step": step})
    assert ck.list_steps() == [1, 2, 3]
    for step in (1, 2, 3):
        assert os.path.exists(os.path.join(ck.ckpt_dir, f"global_step_{step}", "manifest.json"))

    _corrupt_payload(os.path.join(ck.ckpt_dir, "global_step_3"))
    _corrupt_payload(os.path.join(ck.ckpt_dir, "global_step_2"))
    restored, extra = ck.load(tiny_state())
    assert int(extra["global_step"]) == 1
    assert float(restored.model.w.detach()[0]) == 1.0
    assert ck.list_steps() == [1] and ck.latest_step() == 1
    assert os.path.isdir(os.path.join(ck.ckpt_dir, "global_step_3.corrupt"))
    assert os.path.isdir(os.path.join(ck.ckpt_dir, "global_step_2.corrupt"))
    assert not os.path.isdir(os.path.join(ck.ckpt_dir, "global_step_3"))
    assert reg.counter("integrity.ckpt_quarantined").value - q0 == 2
    assert reg.counter("integrity.ckpt_fallbacks").value - f0 == 2

    _corrupt_payload(os.path.join(ck.ckpt_dir, "global_step_1"))
    with pytest.raises(CheckpointCorruptError, match="no trustworthy state"):
        ck.load(tiny_state())
    assert ck.list_steps() == []
    ck.close()


@pytest.mark.parametrize("rename_fails", [False, True], ids=["renamed", "rename-fails"])
def test_resave_supersedes_quarantined_step(tmp_path, monkeypatch, rename_fails):
    ck = build_checkpointer(str(tmp_path / "ck"), async_save=False, verify_mode="size")
    state = tiny_state()
    for step in (1, 2):
        ck.save(step, set_w(state, float(step)), extra_state={"global_step": step})
    _corrupt_payload(os.path.join(ck.ckpt_dir, "global_step_2"))
    if rename_fails:
        real_rename = os.rename

        def flaky_rename(src, dst, *a, **kw):
            if ".corrupt" in str(dst):
                raise OSError("ESTALE: simulated shared-fs rename failure")
            return real_rename(src, dst, *a, **kw)

        monkeypatch.setattr(os, "rename", flaky_rename)
    restored, extra = ck.load(tiny_state())  # quarantines 2, falls back to 1
    assert int(extra["global_step"]) == 1 and ck.latest_step() == 1
    # the corpse stays at the live path only when its rename failed
    assert os.path.isdir(os.path.join(ck.ckpt_dir, "global_step_2")) == rename_fails

    ck.save(2, set_w(state, 2.0), extra_state={"global_step": 2})
    assert ck.list_steps() == [1, 2] and ck.latest_step() == 2
    assert os.path.isdir(os.path.join(ck.ckpt_dir, "global_step_2.corrupt")) != rename_fails
    restored2, extra2 = ck.load(tiny_state())
    assert int(extra2["global_step"]) == 2 and float(restored2.model.w.detach()[0]) == 2.0
    ck.close()


def test_ckpt_verify_mode_gates_bitflip_detection(tmp_path):
    ck = build_checkpointer(str(tmp_path / "ck"), async_save=False, verify_mode="full")
    state = tiny_state(3.0)
    ck.save(1, state, extra_state={"global_step": 1})
    ck.save(2, state, extra_state={"global_step": 2})
    _corrupt_payload(os.path.join(ck.ckpt_dir, "global_step_2"), op="bitflip")
    ck_size = build_checkpointer(str(tmp_path / "ck"), async_save=False, verify_mode="size")
    rep = ck_size.verify_step(2)
    assert rep is not None and rep.passed
    restored, extra = ck.load(tiny_state())
    assert int(extra["global_step"]) == 1
    assert os.path.isdir(os.path.join(ck.ckpt_dir, "global_step_2.corrupt"))
    ck_off = build_checkpointer(str(tmp_path / "ck"), async_save=False, verify_mode="off")
    assert ck_off.verify_step(1) is None
    with pytest.raises(ValueError, match="unknown ckpt verify mode"):
        build_checkpointer(str(tmp_path / "x"), verify_mode="paranoid")
    for c in (ck, ck_size, ck_off):
        c.close()


def test_quarantined_dirs_age_out_beyond_max_to_keep(tmp_path):
    ck = build_checkpointer(str(tmp_path / "ck"), async_save=False, max_to_keep=2)
    for name in ("global_step_1.corrupt", "global_step_2.corrupt", "global_step_3.corrupt.1"):
        d = tmp_path / "ck" / name / "train_state"
        d.mkdir(parents=True)
        (d / "junk.bin").write_bytes(b"z" * 8)
    ck.save(10, tiny_state(), extra_state={"global_step": 10})
    corpses = sorted(d for d in os.listdir(tmp_path / "ck") if ".corrupt" in d)
    assert corpses == ["global_step_2.corrupt", "global_step_3.corrupt.1"]
    assert ck.list_steps() == [10]
    ck.close()


def test_async_save_error_surfaced_and_evicted(tmp_path):
    ck = build_checkpointer(str(tmp_path / "ck"), async_save=True)
    state = tiny_state()
    ck.save(1, state, extra_state={"global_step": 1})
    ck.wait()
    assert ck.list_steps() == [1]
    ck._saved_steps.add(2)
    ck._inflight_step = 2
    ck._ckptr.check_for_errors = lambda: (_ for _ in ()).throw(IOError("commit failed"))
    with pytest.raises(IOError, match="commit failed"):
        ck.wait()
    assert 2 not in ck._saved_steps
    del ck._ckptr.check_for_errors
    ck.save(2, state, extra_state={"global_step": 2})
    ck.wait()
    assert ck.list_steps() == [1, 2]
    ck.close()


def test_async_writer_failure_evicts_its_step(tmp_path, monkeypatch):
    """A real failure on the writer thread (not a patched probe): the next
    save boundary surfaces it, evicts the step, and a re-save commits."""
    from veomni_tpu_torch.checkpoint import checkpointer as ckmod

    ck = build_checkpointer(str(tmp_path / "ck"), async_save=True, io_retries=0)
    real_save = ckmod.torch.save
    calls = []

    def failing_save(obj, f):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("disk full")
        return real_save(obj, f)

    monkeypatch.setattr(ckmod.torch, "save", failing_save)
    ck.save(1, tiny_state(), extra_state={"global_step": 1})
    ck.save(2, tiny_state(), extra_state={"global_step": 2})  # surfaces 1's failure
    ck.wait()
    assert ck.list_steps() == [2] and 1 not in ck._saved_steps
    ck.save(1, tiny_state(), extra_state={"global_step": 1})
    ck.wait()
    assert ck.list_steps() == [1, 2]
    ck.close()


def test_extra_state_precedes_payload_commit(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False, io_retries=0)
    configure_faults([{"point": "ckpt.save", "mode": "exception"}])
    with pytest.raises(InjectedFault):
        ck.save(3, tiny_state(), extra_state={"global_step": 3},
                rank_state={"dataloader": {"cursor": 7}})
    step_dir = tmp_path / "ck" / "global_step_3"
    assert (step_dir / "extra_state.json").exists()
    assert (step_dir / "extra_state_rank0.json").exists()
    assert not (step_dir / "train_state").exists()
    assert ck.list_steps() == []
    ck.close()


def test_crash_debris_removed_at_startup(tmp_path):
    ck = build_checkpointer(str(tmp_path / "ck"), async_save=False)
    ck.save(1, tiny_state(), extra_state={"global_step": 1})
    ck.close()
    torn = tmp_path / "ck" / "global_step_2" / "train_state.tmp-123"
    torn.mkdir(parents=True)
    (torn / "model.pt").write_bytes(b"half")
    stale = tmp_path / "ck" / "global_step_1" / "train_state.tmp-456"
    stale.mkdir()
    ck2 = build_checkpointer(str(tmp_path / "ck"), async_save=False)
    assert not (tmp_path / "ck" / "global_step_2").exists()
    assert not stale.exists()
    assert ck2.list_steps() == [1]
    ck2.close()


# ------------------------------------------------------ trainer resilience


def dense_args(tmp_path, out_name="out", **train_overrides):
    args = VeOmniArguments()
    args.model.config_overrides = dict(DENSE_TOY)
    args.data.train_path = str(tmp_path / "data.jsonl")
    args.data.data_type = "pretokenized"
    args.data.max_seq_len = 64
    args.train.output_dir = str(tmp_path / out_name)
    for k, v in {**dict(platform="cpu", micro_batch_size=2, train_steps=4, lr=1e-3, bf16=False,
                        async_save=False, save_hf_weights=False, prefetch_depth=0, log_steps=1,
                        resilience_retry_base_s=0.001), **train_overrides}.items():
        setattr(args.train, k, v)
    return args


def train_with_loss_log(args):
    """(ctl, {step: loss bits}, trainer); replayed steps overwrite."""
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback

    trainer = TextTrainer(args)
    losses = {}

    class Rec(Callback):
        def on_step_end(self, t, state):
            if state.synced:
                losses[state.global_step] = float(state.metrics["loss"]).hex()

    trainer.callbacks.append(Rec())
    ctl = trainer.train()
    return ctl, losses, trainer


def test_nan_skip_counts_anomaly_and_completes(tmp_path):
    _write_data(tmp_path / "data.jsonl")
    configure_faults([{"point": "step.loss", "mode": "nan", "hit": 2}])
    ctl, losses, trainer = train_with_loss_log(dense_args(tmp_path,
                                                          resilience_rollback_after=10))
    trainer.checkpointer.close()
    assert ctl.global_step == 4
    assert ctl.resilience["anomalies"] == 1
    assert ctl.resilience["anomaly_steps"] == [2]
    assert ctl.resilience["rollbacks"] == 0
    assert all(np.isfinite(float.fromhex(h)) for h in losses.values())


def test_rollback_replays_bit_exact(tmp_path):
    _write_data(tmp_path / "data.jsonl")
    ctl_a, losses_a, trainer_a = train_with_loss_log(
        dense_args(tmp_path, "clean", train_steps=6, save_steps=2))
    ref = {n: p.detach().clone() for n, p in trainer_a.train_state.model.named_parameters()}
    trainer_a.checkpointer.close()
    destroy_parallel_state()

    configure_faults([{"point": "step.loss", "mode": "nan", "hit": 4, "times": 2}])
    ctl_b, losses_b, trainer_b = train_with_loss_log(
        dense_args(tmp_path, "faulty", train_steps=6, save_steps=2,
                   resilience_rollback_after=2))
    assert ctl_b.global_step == 6
    assert ctl_b.resilience["rollbacks"] == 1
    assert ctl_b.resilience["anomalies"] == 2
    assert ctl_b.resilience["anomaly_steps"] == [4, 5]
    for n, p in trainer_b.train_state.model.named_parameters():
        assert torch.equal(p, ref[n]), n
    assert losses_a == losses_b
    trainer_b.checkpointer.close()


def test_rollback_without_checkpoint_is_impossible(tmp_path):
    from veomni_tpu_torch.resilience import RollbackImpossible

    _write_data(tmp_path / "data.jsonl")
    configure_faults([{"point": "step.loss", "mode": "nan", "hit": 2, "times": 2}])
    with pytest.raises(RollbackImpossible):
        train_with_loss_log(dense_args(tmp_path, save_steps=0, resilience_rollback_after=2))


def test_anomaly_budget_aborts(tmp_path):
    from veomni_tpu_torch.resilience import AnomalyBudgetExceeded

    _write_data(tmp_path / "data.jsonl")
    configure_faults([{"point": "step.loss", "mode": "nan", "hit": 2, "times": 6}])
    with pytest.raises(AnomalyBudgetExceeded):
        train_with_loss_log(dense_args(tmp_path, train_steps=8, resilience_anomaly_budget=2,
                                       resilience_rollback_after=10))
    assert os.path.exists(tmp_path / "out" / "postmortem-0.json")


def test_ckpt_save_fault_survived_within_retry_budget(tmp_path):
    _write_data(tmp_path / "data.jsonl")
    configure_faults([{"point": "ckpt.save", "mode": "exception", "hit": 1, "times": 2}])
    ctl, _, trainer = train_with_loss_log(dense_args(tmp_path, save_steps=2,
                                                     resilience_io_retries=3))
    trainer.checkpointer.close()
    assert ctl.global_step == 4
    assert len(fired_faults()) == 2
    assert trainer.checkpointer.list_steps() == [2, 4]


def test_ckpt_save_retry_exhaustion_aborts_run(tmp_path):
    _write_data(tmp_path / "data.jsonl")
    configure_faults([{"point": "ckpt.save", "mode": "exception", "times": 20}])
    with pytest.raises(InjectedFault):
        train_with_loss_log(dense_args(tmp_path, save_steps=2, resilience_io_retries=1))


def test_ckpt_restore_fault_survived_within_retry_budget(tmp_path):
    from veomni_tpu_torch.trainer import TextTrainer

    _write_data(tmp_path / "data.jsonl")
    _, _, trainer = train_with_loss_log(dense_args(tmp_path, save_steps=2))
    trainer.checkpointer.close()
    destroy_parallel_state()
    configure_faults([{"point": "ckpt.restore", "mode": "exception", "hit": 1}])
    trainer2 = TextTrainer(dense_args(tmp_path))
    restored, extra = trainer2.try_resume()
    assert restored and int(extra["global_step"]) == 4
    assert len(fired_faults()) == 1
    assert trainer2.train_state.optimizer.num_updates == 4
    trainer2.checkpointer.close()


def test_watchdog_fires_on_stalled_loop_and_run_completes(tmp_path):
    _write_data(tmp_path / "data.jsonl")
    configure_faults([{"point": "step.delay", "mode": "hang", "hit": 3, "seconds": 1.0}])
    ctl, _, trainer = train_with_loss_log(dense_args(tmp_path, resilience_watchdog_s=0.25))
    trainer.checkpointer.close()
    assert ctl.global_step == 4
    assert ctl.resilience["watchdog_stalls"] >= 1


def test_step_params_drill_plants_a_real_nan(tmp_path):
    """The poisoned parameter makes the next step non-finite; with
    skip_nonfinite the update is skipped and the supervisor counts it."""
    _write_data(tmp_path / "data.jsonl")
    configure_faults([{"point": "step.params", "mode": "nan", "hit": 2, "group": "q_proj"}])
    ctl, losses, trainer = train_with_loss_log(dense_args(tmp_path, resilience_rollback_after=10))
    trainer.checkpointer.close()
    assert ctl.resilience["anomalies"] >= 1 and ctl.resilience["anomaly_steps"][0] == 2
    assert not np.isfinite(float.fromhex(losses[2]))
    assert torch.isnan(trainer.train_state.model.layers[0].q_proj).any()
