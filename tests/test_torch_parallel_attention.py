"""Sequence-parallel attention of the port (``veomni_tpu_torch/parallel/
{sequence_parallel,async_ulysses,ring_attention}.py``) on the CPU, each
rank a gloo process (``parallel/launch.py::run_ranks``).

Every case (causal, non-causal, a causal sliding window, no segment ids,
GQA with ``ulysses > kv_heads`` so the kv heads repeat, and sinks) runs at
ulysses 2, cp 2 (the ring), async Ulysses (4 head chunks requested, clamped
to 2) on a world of 2, and ulysses 2 x cp 2 (the USP layout) and cp 4 on a
world of 4. The ranks' output chunks, reassembled, are held within 2e-5 of
local attention (the port's plain ``_attention_xla`` on the whole sequence,
itself within 2e-5 of the JAX package's), and their q/k/v gradients (the
sinks': summed over the ranks) within 5e-5 of local attention's: the
tolerances of ``tests/test_ring_attention.py`` and
``tests/test_async_ulysses.py``. The layouts of one world size run in one
world.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.ops.attention import _attention_xla as j_attention
from veomni_tpu_torch.ops.attention import _attention_xla
from veomni_tpu_torch.parallel.launch import run_ranks

from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)
from torch_parallel_fixtures import save_tree

B, S, HQ, HKV, D = 2, 64, 8, 2, 16
TESTS = os.path.dirname(os.path.abspath(__file__))
ENV = {"PYTHONPATH": os.pathsep.join([TESTS, os.path.dirname(TESTS)])}
WORLDS = {
    2: {"ulysses2": dict(ulysses=2, cp=1), "cp2": dict(ulysses=1, cp=2),
        "async2": dict(ulysses=2, cp=1, chunks=4)},
    4: {"ulysses2_cp2": dict(ulysses=2, cp=2), "cp4": dict(ulysses=1, cp=4)},
}


def make_cases(seed=0):
    rng = np.random.default_rng(seed)

    def case(causal=1, window=0, seg=True, sinks=False, hkv=HKV):
        c = dict(q=rng.standard_normal((B, S, HQ, D)).astype(np.float32),
                 k=rng.standard_normal((B, S, hkv, D)).astype(np.float32),
                 v=rng.standard_normal((B, S, hkv, D)).astype(np.float32),
                 dout=rng.standard_normal((B, S, HQ, D)).astype(np.float32),
                 causal=np.int32(causal), window=np.int32(window))
        if seg:  # packed rows with boundaries inside the sp chunks
            s = np.ones((B, S), np.int32)
            s[:, 37:] = 2
            s[1, 50:] = 3
            c["seg"] = s
        if sinks:
            c["sinks"] = rng.standard_normal(HQ).astype(np.float32)
        return c

    return {"causal": case(), "full": case(causal=0), "window": case(window=9),
            "noseg": case(seg=False), "gqa_repeat": case(hkv=1), "sinks": case(sinks=True)}


def local(c):
    """The port's plain attention on the whole sequence: output and grads."""
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in c.items()}
    q, k, v = (t[n].clone().requires_grad_(True) for n in "qkv")
    sinks = t["sinks"].clone().requires_grad_(True) if "sinks" in t else None
    out = _attention_xla(q, k, v, t.get("seg"), causal=bool(c["causal"]),
                         sliding_window=int(c["window"]) or None, sinks=sinks)
    out.backward(t["dout"])
    res = dict(out=out.detach(), dq=q.grad, dk=k.grad, dv=v.grad)
    if sinks is not None:
        res["dsinks"] = sinks.grad
    return {k: v.numpy() for k, v in res.items()}


@pytest.fixture(scope="module")
def cases():
    return make_cases()


@pytest.fixture(scope="module")
def refs(cases):
    return {name: local(c) for name, c in cases.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, cases):
    """Each world run once: {world: (output dir, each rank's sp_rank a layout)}."""
    out = {}
    for world, layouts in WORLDS.items():
        path = tmp_path_factory.mktemp(f"world{world}")
        save_tree(str(path / "in.npz"), cases)
        ranks = run_ranks(world, "torch_parallel_fixtures:attention_world",
                          {"layouts": layouts, "npz": str(path / "in.npz"), "out": str(path)},
                          env=ENV, timeout=300)
        out[world] = (path, ranks)
    return out


def test_local_attention_is_the_jax_one(cases, refs):
    for name, c in cases.items():
        want = j_attention(*(jnp.asarray(c[n]) for n in "qkv"),
                           segment_ids=None if "seg" not in c else jnp.asarray(c["seg"]),
                           causal=bool(c["causal"]), sliding_window=int(c["window"]) or None,
                           sinks=None if "sinks" not in c else jnp.asarray(c["sinks"]))
        np.testing.assert_allclose(refs[name]["out"], np.asarray(want), rtol=2e-5, atol=2e-5,
                                   err_msg=name)


LAYOUTS = [(w, lay) for w, layouts in WORLDS.items() for lay in layouts]
CASES = ["causal", "full", "window", "noseg", "gqa_repeat", "sinks"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world,layout", LAYOUTS, ids=[lay for _, lay in LAYOUTS])
def test_sp_attention_matches_local_attention(worlds, refs, world, layout, case):
    path, ranks = worlds[world]
    # rank r's chunk of the sequence is its sp_rank's (cp outer)
    assert sorted(ranks[r][layout] for r in range(world)) == list(range(world))
    order = sorted(range(world), key=lambda r: ranks[r][layout])
    parts = [np.load(path / f"rank{r}-{layout}-{case}.npz") for r in order]
    got = {k: np.concatenate([p[k] for p in parts], axis=1) for k in ("out", "dq", "dk", "dv")}
    ref = refs[case]
    np.testing.assert_allclose(got["out"], ref["out"], rtol=2e-5, atol=2e-5, err_msg="out")
    for k in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[k], ref[k], rtol=5e-5, atol=5e-5, err_msg=k)
    if "dsinks" in ref:
        np.testing.assert_allclose(sum(p["dsinks"] for p in parts), ref["dsinks"],
                                   rtol=5e-5, atol=5e-5, err_msg="sinks")
