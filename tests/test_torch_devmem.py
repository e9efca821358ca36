"""The port's device-memory accounting (``veomni_tpu_torch/observability/devmem.py``)
on the CPU, beside the JAX module's contracts.

* ``buffer_census`` counts a storage once: a tensor, its views, slices,
  a reshape and a parameter over it add its bytes once, a clone adds a
  second buffer; the ``top`` table and ``by_dtype`` agree with the
  reference's document keys.
* ``publish_memory_gauges`` publishes the ``mem.*`` family with a live
  ``host_rss_bytes`` and the watermark on the CPU.
* ``is_resource_exhausted`` takes a ``torch.cuda.OutOfMemoryError`` and
  the allocator's message as the reference takes ``RESOURCE_EXHAUSTED``,
  and ``attach_oom_extra`` gives the post-mortem the buffer census and the
  cost census, and nothing for another error.
* The trainer's crash path: an OOM raised inside a step leaves a
  post-mortem that holds the buffer census.
"""

import json
import os

import pytest
import torch

from veomni_tpu_torch.observability.devmem import (
    attach_oom_extra,
    buffer_census,
    debug_memory_doc,
    is_resource_exhausted,
    publish_memory_gauges,
)
from veomni_tpu_torch.observability.metrics import MetricsRegistry

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

# a shape no other live tensor of the test process has
SHAPE = (977, 131)


def _rows(census):
    return [g for g in census["top"] if tuple(g["shape"]) in (SHAPE, (SHAPE[1], SHAPE[0]))]


def test_views_count_once():
    base = torch.zeros(SHAPE, dtype=torch.float32)
    views = [base.view(-1), base[3:], base.t(), base.reshape(SHAPE[1], SHAPE[0]), base[:, 1]]
    param = torch.nn.Parameter(base)  # shares the storage
    census = buffer_census(top_k=10_000)
    rows = _rows(census)
    assert sum(g["count"] for g in rows) == 1
    assert sum(g["bytes"] for g in rows) == base.numel() * 4
    copy = base.clone()
    rows = _rows(buffer_census(top_k=10_000))
    assert sum(g["count"] for g in rows) == 2
    assert sum(g["bytes"] for g in rows) == 2 * base.numel() * 4
    assert set(census) == {"total_bytes", "num_arrays", "by_dtype", "top"}  # the reference's
    assert census["by_dtype"]["float32"]["bytes"] >= base.numel() * 4
    del views, param, copy


def test_memory_gauges_live_on_cpu():
    reg = MetricsRegistry()
    stats = publish_memory_gauges(reg)
    assert stats["host_rss_bytes"] > 0 and "high_watermark_bytes" in stats
    assert reg.gauge("mem.host_rss_bytes").value == stats["host_rss_bytes"]
    doc = debug_memory_doc(lambda: {"pool_bytes": 1.0}, top_k=2)
    assert doc["pool"] == {"pool_bytes": 1.0} and len(doc["buffer_census"]["top"]) <= 2


def test_oom_detection_and_report():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert is_resource_exhausted(oom)
    assert is_resource_exhausted(RuntimeError("CUDA error: out of memory"))
    assert not is_resource_exhausted(ValueError("bad shape"))
    held = torch.ones(SHAPE)
    extra = attach_oom_extra(oom, {"error": "x"})
    assert {"buffer_census", "cost_census", "memory"} <= set(extra)
    assert extra["buffer_census"]["total_bytes"] >= held.numel() * 4
    assert attach_oom_extra(ValueError("bad"), {"error": "x"}) == {"error": "x"}


def test_trainer_oom_postmortem_holds_the_buffer_census(tmp_path):
    from veomni_tpu_torch.parallel.parallel_state import destroy_parallel_state
    from veomni_tpu_torch.trainer import TextTrainer
    from veomni_tpu_torch.trainer.callbacks import Callback

    from test_e2e_training import _write_dummy_data
    from test_torch_trainer import port_args

    class Oom(Callback):
        def on_step_begin(self, trainer, state):
            if state.global_step == 1:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory (drill)")

    _write_dummy_data(tmp_path / "data.jsonl")
    args = port_args(tmp_path, train_steps=3)
    trainer = TextTrainer(args)
    trainer.callbacks.append(Oom())
    with pytest.raises(torch.cuda.OutOfMemoryError):
        trainer.train()
    trainer.checkpointer.close()
    destroy_parallel_state()
    with open(os.path.join(args.train.output_dir, "postmortem-0.json")) as f:
        pm = json.load(f)
    assert pm["reason"] == "exception:OutOfMemoryError"
    census = pm["extra"]["buffer_census"] if "extra" in pm else pm["buffer_census"]
    assert census["num_arrays"] > 0 and census["top"]
