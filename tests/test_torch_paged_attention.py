"""Port paged attention and the dense serving storage vs the JAX reference.

f32 on the CPU, inputs from numpy seeds:

* ``cache_attend`` against ``veomni_tpu.ops.paged_attention.cache_attend``
  at GQA repeats 1, 2 and 4, with and without sinks, on masks with causal
  and length structure (atol 1e-5, rtol 1e-5);
* ``gather_block_kv`` equal to the reference's, on null-padded tables;
* ``paged_attend`` (decode, T=1 and the verify width T=4) and
  ``paged_prefill_attend`` (one sequence, a T-row chunk) against the
  reference's ops on the same pool and null-padded tables (atol/rtol 1e-5);
* the dense storage tier: ``make_kv_pool``/``kv_block_nbytes``/``decode_dot``
  against the reference; the int8 pool, block bytes and weights equal to the
  reference's, and ``fp8`` raising the reference's message.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.ops import paged_attention as jpa
from veomni_tpu.ops import quantization as jq
from veomni_tpu_torch import ops
from veomni_tpu_torch.ops import paged_attention as tpa
from veomni_tpu_torch.ops import quantization as tq
from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

TOL = dict(atol=1e-5, rtol=1e-5)
T = torch.from_numpy


def _pool(rng, nb=9, bs=4, hkv=2, d=16):
    k = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    v = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    return k, v


def _tables(rng, s, nb_used, nbb, nb_pool):
    """[s, nbb] tables: each row holds its own distinct blocks (never the
    null block 0) for its first nb_used[i] entries, then 0 padding."""
    tables = np.zeros((s, nbb), np.int32)
    for i, n in enumerate(nb_used):
        tables[i, :n] = rng.choice(np.arange(1, nb_pool), n, replace=False)
    return tables


@pytest.mark.parametrize("num_rep", [1, 2, 4])
@pytest.mark.parametrize("with_sinks", [False, True], ids=["plain", "sinks"])
def test_cache_attend_matches_jax(num_rep, with_sinks):
    rng = np.random.default_rng(num_rep + 10 * with_sinks)
    b, t, m, hkv, d = 3, 5, 24, 2, 16
    hq = hkv * num_rep
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, m, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, m, hkv, d)).astype(np.float32)
    lengths = np.array([24, 13, 7])
    qpos = lengths[:, None] - t + np.arange(t)[None]  # the last t rows of each
    mask = (np.arange(m)[None, None] <= qpos[:, :, None]) & (
        np.arange(m)[None, None] < lengths[:, None, None])
    sinks = rng.standard_normal(hq).astype(np.float32) if with_sinks else None
    want = jpa.cache_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                            num_rep=num_rep, scale=d ** -0.5,
                            sinks=None if sinks is None else jnp.asarray(sinks))
    got = tpa.cache_attend(T(q), T(k), T(v), T(mask), num_rep=num_rep, scale=d ** -0.5,
                           sinks=None if sinks is None else T(sinks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gather_block_kv_matches_jax():
    rng = np.random.default_rng(0)
    k, v = _pool(rng)
    tables = _tables(rng, 3, [2, 4, 1], 4, k.shape[0])
    want_k, want_v = jpa.gather_block_kv(jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables))
    got_k, got_v = ops.gather_block_kv(T(k), T(v), T(tables).long())
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("t", [1, 4], ids=["decode", "verify"])
def test_paged_attend_matches_jax(t):
    rng = np.random.default_rng(t)
    bs, hkv, d, num_rep = 4, 2, 16, 2
    k, v = _pool(rng, nb=13, bs=bs, hkv=hkv, d=d)
    used = [3, 1, 4]
    tables = _tables(rng, 3, used, 4, k.shape[0])
    positions = np.array([n * bs - 1 - t for n in used]).clip(0)[:, None] + np.arange(t)[None]
    mask = np.arange(4 * bs)[None, None] <= positions[:, :, None]
    q = rng.standard_normal((3, t, hkv * num_rep, d)).astype(np.float32)
    want = jpa.paged_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
                            jnp.asarray(mask), num_rep=num_rep, scale=d ** -0.5)
    got = ops.paged_attend(T(q), T(k), T(v), T(tables).long(), T(mask), num_rep=num_rep,
                           scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_prefill_attend_matches_jax():
    rng = np.random.default_rng(5)
    bs, hkv, d, num_rep, chunk = 4, 2, 16, 4, 8
    k, v = _pool(rng, nb=11, bs=bs, hkv=hkv, d=d)
    tables = _tables(rng, 1, [5], 8, k.shape[0])  # 5 of 8 entries, null-padded
    start = 11  # a cached prefix of 11 rows, then the chunk
    positions = start + np.arange(chunk)
    mask = (np.arange(8 * bs)[None, None] <= positions[None, :, None])
    q = rng.standard_normal((1, chunk, hkv * num_rep, d)).astype(np.float32)
    want = jpa.paged_prefill_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(tables), jnp.asarray(mask), num_rep=num_rep,
                                    scale=d ** -0.5)
    got = ops.paged_prefill_attend(T(q), T(k), T(v), T(tables).long(), T(mask),
                                   num_rep=num_rep, scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_registry_names_match_reference():
    for op, impl in (("paged_attention", "xla_gather"), ("paged_prefill_attention", "xla_gather"),
                     ("decode_matmul", "xla")):
        assert impl in KERNEL_REGISTRY.impls(op), (op, impl)


def test_dense_storage_tier_matches_jax():
    shape = (2, 5, 4, 2, 16)
    pool = tq.make_kv_pool(shape, "none", torch.float32, "cpu")
    assert tuple(pool.shape) == shape and not pool.any()
    assert tq.kv_pool_nbytes(pool) == jq.kv_pool_nbytes(jq.make_kv_pool(shape, "none",
                                                                         jnp.float32))
    for dtype_bytes in (2, 4):
        assert (tq.kv_block_nbytes(28, 16, 8, 128, dtype_bytes=dtype_bytes)
                == jq.kv_block_nbytes(28, 16, 8, 128, dtype_bytes=dtype_bytes))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2, 16)).astype(np.float32)
    w = rng.standard_normal((16, 24)).astype(np.float32)
    np.testing.assert_allclose(ops.decode_dot(T(x), T(w)).numpy(),
                               np.asarray(jq.decode_dot(jnp.asarray(x), jnp.asarray(w))), **TOL)


def _int8_pool():
    pool_t = tq.make_kv_pool((1, 2, 4, 1, 8), "int8", torch.float32)
    pool_j = jq.make_kv_pool((1, 2, 4, 1, 8), "int8", jnp.float32)
    for a, b in ((pool_t.data, pool_j.data), (pool_t.scale, pool_j.scale)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype) and tuple(a.shape) == b.shape
        assert not a.any()
    assert tq.kv_pool_nbytes(pool_t) == jq.kv_pool_nbytes(pool_j)


def _fp8_pool():
    with pytest.raises(NotImplementedError) as ref:
        jq.make_kv_pool((1, 2, 4, 1, 8), "fp8", jnp.float32)
    with pytest.raises(NotImplementedError) as got:
        tq.make_kv_pool((1, 2, 4, 1, 8), "fp8", torch.float32)
    assert str(got.value) == str(ref.value)


def _int8_block_bytes():
    assert (tq.kv_block_nbytes(2, 16, 2, 64, kv_quant="int8")
            == jq.kv_block_nbytes(2, 16, 2, 64, kv_quant="int8"))


def _int8_weights():
    w = np.random.default_rng(2).standard_normal((2, 16, 24)).astype(np.float32)
    ref = jq.quantize_decode_params({"layers": {"q_proj": jnp.asarray(w)}})["layers"]["q_proj"]
    got = tq.quantize_decode_params({"layers": [{"q_proj": T(w[i])} for i in range(2)]})
    for i in range(2):
        assert np.array_equal(got["layers"][i]["q_proj"].data.numpy(), np.asarray(ref.data[i]))
        assert np.array_equal(got["layers"][i]["q_proj"].scale.numpy(), np.asarray(ref.scale[i]))


@pytest.mark.parametrize("call", [_int8_pool, _fp8_pool, _int8_block_bytes, _int8_weights],
                         ids=["kv-int8", "kv-fp8", "block-bytes-int8", "weight-int8"])
def test_quantized_tiers_not_ported(call):
    """The int8 tiers are ported: each equals the reference's (the rest of
    their parity is ``tests/test_torch_kv_quant.py``); ``fp8`` is the tier
    the reference itself does not ship, and both raise its message."""
    call()
    with pytest.raises(ValueError, match="unknown kv_quant"):
        tq.make_kv_pool((1, 2, 4, 1, 8), "int4", torch.float32)
