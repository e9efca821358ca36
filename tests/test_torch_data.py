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
