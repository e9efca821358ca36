"""The port's data path (``veomni_tpu_torch.data``) against the reference's.

The dataset, transform and dataloader modules are copies of the
reference's (numpy only); held here on identical inputs:

* the trainer's pipeline (pretokenized transform -> mapping dataset ->
  packing collator -> native loader) yields byte-identical batches and
  equal cursor documents, batch by batch across an epoch boundary, with
  grad accumulation and packing carry-over;
* a cursor round-trips through JSON: a fresh loader that loads it yields
  what the original yields next, and the reference's cursor loaded into the
  port's loader continues alike;
* the plaintext transform (with a stand-in tokenizer), the iterable,
  interleave and weighted datasets and their resumable states match;
* ``len()`` of the loader matches.
"""

import json

import pytest

from veomni_tpu.data import data_collator as j_collator
from veomni_tpu.data import data_loader as j_loader
from veomni_tpu.data import data_transform as j_transform
from veomni_tpu.data import dataset as j_dataset
from veomni_tpu_torch.data import data_collator, data_loader, data_transform, dataset

from test_e2e_training import _write_dummy_data
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

PORT = (dataset, data_transform, data_collator, data_loader)
REF = (j_dataset, j_transform, j_collator, j_loader)


def loader(mods, path, *, seq_len=128, micro_bs=2, accum=2, seed=7):
    ds_mod, tf_mod, col_mod, dl_mod = mods
    ds = ds_mod.build_dataset("mapping", path=str(path),
                              transform=tf_mod.build_data_transform("pretokenized"))
    collator = col_mod.TextPackingCollator(seq_len=seq_len, micro_batch_size=micro_bs)
    return dl_mod.build_dataloader("native", dataset=ds, collate_fn=collator,
                                   micro_batch_size=micro_bs, grad_accum_steps=accum,
                                   samples_per_micro_batch=8 * micro_bs, seed=seed,
                                   drop_last=True, infinite=True)


def assert_same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("accum", [1, 2])
def test_batches_and_cursors_byte_identical(tmp_path, accum):
    _write_dummy_data(tmp_path / "data.jsonl", n=128)
    port, ref = loader(PORT, tmp_path / "data.jsonl", accum=accum), \
        loader(REF, tmp_path / "data.jsonl", accum=accum)
    assert len(port) == len(ref)
    it_p, it_r = iter(port), iter(ref)
    epochs = set()
    for _ in range(40):
        b = next(it_p)
        assert_same_batch(b, next(it_r))
        assert b["input_ids"].shape == (accum, 2, 128)
        assert port.state_dict() == ref.state_dict()
        epochs.add(port.state_dict()["epoch"])
    assert len(epochs) > 1  # the run crossed epoch boundaries
    assert port.state_dict()["collator"]["pending"]  # with carry-over in the cursor


def test_cursor_round_trip(tmp_path):
    _write_dummy_data(tmp_path / "data.jsonl", n=128)
    port, ref = loader(PORT, tmp_path / "data.jsonl"), loader(REF, tmp_path / "data.jsonl")
    it_p, it_r = iter(port), iter(ref)
    for _ in range(7):
        next(it_p), next(it_r)
    saved = json.loads(json.dumps(port.state_dict()))
    saved_ref = json.loads(json.dumps(ref.state_dict()))
    ahead = [next(it_p) for _ in range(5)]
    for state in (saved, saved_ref):  # its own cursor, and the reference's
        resumed = loader(PORT, tmp_path / "data.jsonl")
        resumed.load_state_dict(state)
        it = iter(resumed)
        for want in ahead:
            assert_same_batch(next(it), want)
        assert resumed.state_dict() == port.state_dict()


class CharTokenizer:
    """Stand-in tokenizer: one id per byte, a leading BOS."""

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": ([1] if add_special_tokens else []) + list(text.encode())}


def test_plaintext_transform_matches():
    rows = [{"text": "hello packed world"}, {"text": "x" * 50}]
    for max_len in (0, 16):
        got = data_transform.build_data_transform(
            "plaintext", tokenizer=CharTokenizer(), max_seq_len=max_len)
        ref = j_transform.build_data_transform(
            "plaintext", tokenizer=CharTokenizer(), max_seq_len=max_len)
        assert [got(r) for r in rows] == [ref(r) for r in rows]


def test_datasets_and_states_match(tmp_path):
    _write_dummy_data(tmp_path / "a.jsonl", n=20, seed=1)
    _write_dummy_data(tmp_path / "b.jsonl", n=30, seed=2)
    results = []
    for ds_mod in (dataset, j_dataset):
        a = ds_mod.build_dataset("mapping", path=str(tmp_path / "a.jsonl"))
        b = ds_mod.build_dataset("mapping", path=str(tmp_path / "b.jsonl"))
        inter = ds_mod.build_dataset("interleave", datasets=[a, b])
        order = [inter[i]["input_ids"][:3] for i in range(len(inter))]
        it = ds_mod.build_dataset("iterable", path=str(tmp_path / "a.jsonl"))
        first = [r["input_ids"][:2] for r, _ in zip(iter(it), range(5))]
        it_state = it.state_dict()
        weighted = ds_mod.build_dataset("weighted", datasets=[a, b], weights=[0.3, 0.7], seed=5)
        wit = iter(weighted)
        draws = [next(wit)["input_ids"][:2] for _ in range(10)]
        w_state = json.loads(json.dumps(weighted.state_dict()))
        resumed = ds_mod.build_dataset("weighted", datasets=[a, b], weights=[0.3, 0.7], seed=5)
        resumed.load_state_dict(w_state)
        nxt, nxt_resumed = next(wit)["input_ids"], next(iter(resumed))["input_ids"]
        assert nxt == nxt_resumed
        results.append((order, first, it_state, draws, w_state, nxt))
    assert results[0] == results[1]


# --------------------------------------------------------------------------
# dynamic batching, prefetch, streaming (copies of the reference's modules)
# --------------------------------------------------------------------------
def dyn_loader(mods, dyn_mod, path, *, warmup_steps=0, accum=2, buffer_size=24):
    ds_mod, tf_mod, col_mod, _ = mods
    ds = ds_mod.build_dataset("mapping", path=str(path),
                              transform=tf_mod.build_data_transform("pretokenized"))
    collator = col_mod.TextPackingCollator(seq_len=128, micro_batch_size=2)
    return dyn_mod.DynamicBatchDataloader(ds, collator, token_budget=2 * 128,
                                          grad_accum_steps=accum, buffer_size=buffer_size,
                                          warmup_steps=warmup_steps, seed=5)


@pytest.mark.parametrize("warmup_steps", [0, 6], ids=["steady", "warmup-ramp"])
def test_dyn_bsz_batches_and_cursor_match(tmp_path, warmup_steps):
    """DynamicBatchDataloader: byte-identical batches and equal cursors
    across an epoch boundary (with the warmup ramp too); the cursor
    round-trips through JSON into a fresh port loader, which yields what
    the original yields next."""
    from veomni_tpu.data import dynamic_batching as j_dyn
    from veomni_tpu_torch.data import dynamic_batching

    _write_dummy_data(tmp_path / "data.jsonl", n=64)
    port = dyn_loader(PORT, dynamic_batching, tmp_path / "data.jsonl", warmup_steps=warmup_steps)
    ref = dyn_loader(REF, j_dyn, tmp_path / "data.jsonl", warmup_steps=warmup_steps)
    assert len(port) == len(ref)
    it_p, it_r = iter(port), iter(ref)
    for _ in range(12):
        assert_same_batch(next(it_p), next(it_r))
        assert port.state_dict() == ref.state_dict()
    assert port.state_dict()["epoch"] >= 1 and port.state_dict()["buffer"]["buffer"]
    saved = json.loads(json.dumps(port.state_dict()))
    ahead = [next(it_p) for _ in range(4)]
    resumed = dyn_loader(PORT, dynamic_batching, tmp_path / "data.jsonl",
                         warmup_steps=warmup_steps)
    resumed.load_state_dict(saved)
    it = iter(resumed)
    for want in ahead:
        assert_same_batch(next(it), want)
    assert resumed.state_dict() == port.state_dict()


class _StatefulLoader:
    """The reference prefetch test's loader: an explicit cursor."""

    def __init__(self, n=20, start=0):
        self.n = n
        self.cursor = start

    def __iter__(self):
        import numpy as np

        while self.cursor < self.n:
            item = {"x": np.full((2,), self.cursor)}
            self.cursor += 1
            yield item

    def state_dict(self):
        return {"cursor": self.cursor}


def test_prefetch_consumed_cursor_goes_into_checkpoints():
    """The reference's ``test_prefetcher_consumed_state_resume``: the saved
    cursor is the last CONSUMED batch's, not the worker's."""
    from veomni_tpu_torch.data.prefetch import BackgroundPrefetcher

    pf = BackgroundPrefetcher(_StatefulLoader(n=20), depth=3)
    it = iter(pf)
    assert [int(next(it)["x"][0]) for _ in range(7)] == list(range(7))
    state = pf.state_dict()
    pf.close()
    assert state["cursor"] == 7
    pf2 = BackgroundPrefetcher(_StatefulLoader(n=20, start=state["cursor"]), depth=3)
    assert [int(b["x"][0]) for b in pf2] == list(range(7, 20))
    pf2.close()


def test_prefetch_worker_error_keeps_its_traceback():
    """The reference's exhaustion, error and traceback tests: the worker's
    exception reaches the consumer with the worker's own frames."""
    import traceback

    import numpy as np

    from veomni_tpu_torch.data.prefetch import BackgroundPrefetcher

    assert len(list(BackgroundPrefetcher(_StatefulLoader(n=3), depth=2))) == 3

    def deep_failure():
        raise RuntimeError("shard corrupted")

    class _Boom:
        def __iter__(self):
            yield {"x": np.zeros(1)}
            deep_failure()

    pf = BackgroundPrefetcher(_Boom(), depth=2)
    it = iter(pf)
    next(it)
    with pytest.raises(RuntimeError, match="shard corrupted") as excinfo:
        next(it)
    frames = [f.name for f in traceback.extract_tb(excinfo.value.__traceback__)]
    assert "deep_failure" in frames and "_worker" in frames
    pf.close()
    with pytest.raises(ValueError):
        BackgroundPrefetcher(_StatefulLoader(), depth=0)


def test_prefetch_close_is_idempotent_and_wakes_a_blocked_consumer():
    """The reference's close test: close() wakes a consumer blocked on the
    empty queue with PrefetcherClosed, promptly, and may be called again."""
    import threading
    import time

    import numpy as np

    from veomni_tpu_torch.data.prefetch import BackgroundPrefetcher, PrefetcherClosed

    release = threading.Event()

    class _Stuck:
        def __iter__(self):
            yield {"x": np.zeros(1)}
            release.wait(30.0)

    pf = BackgroundPrefetcher(_Stuck(), depth=1)
    it = iter(pf)
    next(it)
    threading.Timer(0.3, pf.close).start()
    t0 = time.monotonic()
    with pytest.raises(PrefetcherClosed):
        next(it)
    assert time.monotonic() - t0 < 5.0
    pf.close()
    pf.close()
    release.set()


def _shards(tmp_path):
    """A jsonl/tar corpus: 4 jsonl shards and one webdataset tar shard."""
    import io
    import tarfile

    d = tmp_path / "shards"
    d.mkdir()
    for s in range(5):
        rows = [{"input_ids": list(range(s * 100 + i, s * 100 + i + 3 + i % 5))}
                for i in range(7)]
        if s < 4:
            with open(d / f"shard-{s:03d}.jsonl", "w") as f:
                for r in rows:
                    f.write(json.dumps(r) + "\n")
        else:
            with tarfile.open(d / f"shard-{s:03d}.tar", "w") as tf:
                for i, r in enumerate(rows):
                    raw = json.dumps(r).encode()
                    info = tarfile.TarInfo(name=f"{i:05d}.json")
                    info.size = len(raw)
                    tf.addfile(info, io.BytesIO(raw))
    return str(d)


@pytest.mark.parametrize("dp", [(0, 1), (1, 2)], ids=["one-rank", "rank1-of-2"])
def test_streaming_records_and_cursors_match(tmp_path, dp):
    """StreamingShardDataset: the same records in the same order over an
    epoch, equal cursors after every record, random access alike, and a JSON
    round-tripped mid-epoch cursor resumes the port's stream where it
    stopped."""
    path = _shards(tmp_path)

    def build(mod):
        return mod.build_dataset("streaming", path=path, seed=3, dp_rank=dp[0], dp_size=dp[1],
                                 transform=None)

    port, ref = build(dataset), build(j_dataset)
    assert len(port) == len(ref) and [port[i] for i in range(len(port))] == \
        [ref[i] for i in range(len(ref))]
    got, states = [], []
    it_r = iter(ref)
    for a in port:
        assert a == next(it_r) and port.state_dict() == ref.state_dict()
        got.append(a)
        states.append(json.loads(json.dumps(port.state_dict())))
    assert next(it_r, None) is None and len(got) > 10
    assert port.state_dict() == ref.state_dict()  # the next epoch's cursor
    half = len(got) // 2
    resumed = build(dataset)
    resumed.load_state_dict(states[half - 1])
    assert list(resumed) == got[half:]
