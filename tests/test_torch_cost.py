"""The port's cost census (``veomni_tpu_torch/observability/cost.py``) against
the JAX one, on the CPU.

* ``CostWindow``'s arithmetic: the same injected records and calls into
  both censuses, both windows read on one fake clock (1.25 s) with the
  same peaks (989e12 FLOP/s, 3.35e12 B/s): every key equal to rtol 1e-12,
  the numerics site left out of both, and an idle window empty in both.
* ``CostCensus`` bookkeeping as the reference's: ``latest`` by recency,
  ``snapshot`` totals, the ``cost.*`` families.
* The counting pass: an instrumented function of two products counts
  ``2 m k n`` FLOPs each (``torch.utils.flop_counter``), bytes as the ops'
  inputs plus outputs (views free), a hand kernel's report through
  ``note_kernel``; the first call per bucket is measured, later ones only
  counted; ``VEOMNI_COST_CENSUS=0`` returns the function itself; the
  port's trainer records its ``train_step`` bucket; the serving engine's
  sites count only while a reader (the exporter) is open, and each bucket
  once a process, however many engines reach it.
* ``visible_pairs`` (the K1-K3 census count) against a loop over the
  segment ids, causal and full.
"""

import time

import numpy as np
import pytest
import torch

from veomni_tpu.observability.cost import CostCensus as JCensus
from veomni_tpu.observability.cost import CostWindow as JWindow
from veomni_tpu.observability.metrics import MetricsRegistry as JRegistry
from veomni_tpu_torch.observability import cost
from veomni_tpu_torch.observability.cost import CostCensus, CostWindow, instrument_site
from veomni_tpu_torch.observability.metrics import MetricsRegistry
from veomni_tpu_torch.ops.cuda.flash_attention import visible_pairs

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

PEAKS = (989e12, 3.35e12)
RECORDS = [("train_step", "4x128", 3.5e12, 2.25e11), ("train_step", "4x256", 7.25e12, 4e11),
           ("eval_step", "4x128", 1.1e12, 9e10), ("numerics_step", "4x128", 9e15, 9e15)]
CALLS = {("train_step", "4x128"): 3, ("train_step", "4x256"): 2, ("eval_step", "4x128"): 1,
         ("numerics_step", "4x128"): 5}


def test_cost_window_arithmetic_matches_jax(monkeypatch):
    import veomni_tpu.utils.device as jdev

    monkeypatch.setattr(jdev, "get_device_peak_flops", lambda *a, **k: PEAKS[0])
    monkeypatch.setattr(jdev, "get_device_peak_bandwidth", lambda *a, **k: PEAKS[1])
    monkeypatch.setattr(jdev, "get_device_peak_interconnect_bandwidth", lambda *a, **k: 1e11)
    monkeypatch.setattr(cost, "device_peaks", lambda: PEAKS)
    clock = [100.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    j_census, census = JCensus(registry=JRegistry()), CostCensus(registry=MetricsRegistry())
    for site, bucket, flops, nbytes in RECORDS:
        j_census.record(site, bucket, compile_time_s=0.5, flops=flops, bytes_accessed=nbytes)
        census.record(site, bucket, compile_time_s=0.5, flops=flops, bytes_accessed=nbytes)
    j_window, window = JWindow(j_census), CostWindow(census)
    j_window.begin()
    window.begin()
    for key, n in CALLS.items():
        for _ in range(n):
            j_census.note_call(*key)
            census.note_call(*key)
    clock[0] += 1.25
    want, got = j_window.end(), window.end()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    assert got["mfu_pct"] == pytest.approx(100 * (3 * 3.5e12 + 2 * 7.25e12 + 1.1e12)
                                           / 1.25 / PEAKS[0], rel=1e-12)
    assert j_window.end() == window.end() == {}  # an idle window says nothing
    assert census.snapshot()["totals"] == j_census.snapshot()["totals"]
    assert census.latest("train_step").bucket == j_census.latest("train_step").bucket


def test_census_disabled_by_env_is_identity(monkeypatch):
    def fn(x):
        return x

    monkeypatch.setenv("VEOMNI_COST_CENSUS", "0")
    assert instrument_site("s", fn) is fn
    monkeypatch.setenv("VEOMNI_COST_CENSUS", "1")
    assert instrument_site("s", fn) is not fn


def test_counting_pass_flops_bytes_and_kernel_reports():
    census = CostCensus(registry=MetricsRegistry())
    m, k, n = 8, 16, 4
    a, b = torch.randn(m, k), torch.randn(k, n)

    def fn(x, y):
        out = (x @ y).t()  # one product, one view
        cost.note_kernel(lambda: (1000.0, 24.0))  # a hand kernel's launch
        return out @ torch.randn(m, 2)

    site = instrument_site("toy", fn, bucket_fn=lambda args: "x".join(map(str, args[0].shape)),
                           census=census)
    for _ in range(3):
        site(a, b)
    rec = census.get("toy", f"{m}x{k}")
    assert rec.calls == 3 and rec.traces == 1
    assert rec.kernel_flops == 1000.0 and rec.kernel_bytes == 24.0
    assert rec.flops == 2 * m * k * n + 2 * n * m * 2 + 1000.0
    # mm: a, b in, [m, n] out; randn: [m, 2] out; mm: [n, m] and [m, 2] in, [n, 2] out
    want_bytes = 4 * (m * k + k * n + m * n) + 4 * m * 2 + 4 * (n * m + m * 2 + n * 2) + 24
    assert rec.bytes_accessed == want_bytes
    assert cost._COUNTING is None  # the pass is over
    cost.note_kernel(lambda: (5.0, 5.0))  # outside a counting pass: dropped
    assert census.get("toy", f"{m}x{k}").kernel_flops == 1000.0


def test_census_counts_a_bucket_once_a_program():
    """Sites naming one program share its buckets (one counting pass, every
    call noted); a site naming none counts its own, re-recording the
    bucket as a recompile would."""
    census = CostCensus(registry=MetricsRegistry())
    a = torch.randn(4, 4)

    def fn(x):
        return x @ x

    first, second = (instrument_site("s", fn, census=census, program="p") for _ in range(2))
    first(a)
    second(a)
    second(a)
    rec = census.get("s", "call")
    assert rec.traces == 1 and rec.calls == 3 and rec.flops == 2 * 4 * 4 * 4
    instrument_site("s", fn, census=census)(a)
    assert rec.traces == 2 and rec.calls == 4


def test_trainer_records_its_train_step(tmp_path):
    from veomni_tpu_torch.observability.cost import get_cost_census
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import TextTrainer

    from test_e2e_training import _write_dummy_data
    from test_torch_trainer import port_args

    get_cost_census().reset()
    _write_dummy_data(tmp_path / "data.jsonl")
    trainer = TextTrainer(port_args(tmp_path, train_steps=3, log_steps=1))
    trainer.train()
    trainer.checkpointer.close()
    destroy_parallel_state()
    rec = get_cost_census().latest("train_step")
    assert rec is not None and rec.bucket == "1x4x128" and rec.calls == 3
    assert rec.flops > 0 and rec.bytes_accessed > rec.argument_bytes > 0


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_census_changes_no_loss_or_grad_norm(tmp_path, monkeypatch, lora):
    """The census's counting pass runs beside the trainer's step: with it on
    and off the trainer's losses and grad norms are bit-equal."""
    from veomni_tpu_torch.observability.cost import get_cost_census
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import TextTrainer

    from test_e2e_training import _write_dummy_data
    from test_torch_trainer import port_args, record_steps

    _write_dummy_data(tmp_path / "data.jsonl")
    seen = {}
    for on in ("1", "0"):
        get_cost_census().reset()
        monkeypatch.setenv("VEOMNI_COST_CENSUS", on)
        args = port_args(tmp_path, out_name=f"census{on}", train_steps=3)
        if lora:
            args.model.lora = {"rank": 4, "alpha": 8}
        trainer = TextTrainer(args)
        seen[on] = record_steps(trainer)
        trainer.train()
        trainer.checkpointer.close()
        destroy_parallel_state()
        rec = get_cost_census().latest("train_step")
        assert (rec is not None and rec.calls == 3) if on == "1" else rec is None
    assert len(seen["1"]) == 3 and seen["1"] == seen["0"]


@pytest.mark.parametrize("causal", [True, False])
def test_visible_pairs_match_a_loop(causal):
    rng = np.random.default_rng(0)
    seg = torch.from_numpy(np.sort(rng.integers(0, 5, (3, 64)), axis=1)).int()
    seg[1, 40:] = 0  # padding id, not contiguous with the row's first segment
    want = 0
    for row in seg.tolist():
        for i, si in enumerate(row):
            want += sum(1 for j, sj in enumerate(row) if sj == si and (j <= i or not causal))
    assert visible_pairs(seg, causal) == want


def _run_toy_engine():
    """One request (19 prompt tokens, 5 new) through a fresh toy engine."""
    from veomni_tpu_torch.serving import EngineConfig, Request, SamplingParams

    from torch_fleet_fixtures import InferenceEngine, qwen3_models

    _, _, model, cfg = qwen3_models()
    eng = InferenceEngine(model, cfg, EngineConfig(num_blocks=64, block_size=8, num_slots=2,
                                                   max_model_len=64, prefill_chunk=8))
    outs = eng.run([Request(prompt_ids=list(range(1, 20)),
                            sampling=SamplingParams(max_new_tokens=5))])
    assert len(next(iter(outs.values())).token_ids) == 5


def test_engine_records_its_decode_and_prefill_buckets():
    """The serving engine's sites (the reference's ``paged_decode`` and
    ``paged_prefill`` buckets), with a reader open: each bucket's first
    call counted, every call noted."""
    from veomni_tpu_torch.observability.cost import get_cost_census

    get_cost_census().reset()
    cost.open_reader()
    try:
        _run_toy_engine()
    finally:
        cost.close_reader()
    census = get_cost_census()
    decode, prefill = census.programs("paged_decode"), census.programs("paged_prefill")
    assert decode and prefill
    assert sum(r.calls for r in decode) == 4  # the first token comes from the prefill
    assert sum(r.calls for r in prefill) == 3  # 19 prompt tokens in chunks of 8
    assert all(r.flops > 0 and r.traces == 1 for r in decode + prefill)


def test_engine_counts_on_demand_and_each_bucket_once_a_process():
    """Without a reader the serving sites count nothing (no counting pass
    on the hot path); with the exporter running, a second engine reaching
    the buckets the first one counted only notes its calls."""
    from veomni_tpu_torch.observability.cost import get_cost_census
    from veomni_tpu_torch.observability.exporter import MetricsExporter

    census = get_cost_census()
    census.reset()
    _run_toy_engine()
    assert not census.programs("paged_decode") and not census.programs("paged_prefill")
    assert not cost.readers_open()
    exp = MetricsExporter(port=0, host="127.0.0.1", registry=MetricsRegistry())
    exp.start()
    try:
        assert cost.readers_open()
        _run_toy_engine()
        first = {(r.site, r.bucket): r.calls for r in census.programs()}
        _run_toy_engine()  # another engine, as a respawned replica is
    finally:
        exp.stop()
    assert not cost.readers_open()
    progs = census.programs("paged_decode") + census.programs("paged_prefill")
    assert progs and all(r.traces == 1 for r in progs)
    assert {(r.site, r.bucket): r.calls for r in progs} == {k: 2 * n for k, n in first.items()}
