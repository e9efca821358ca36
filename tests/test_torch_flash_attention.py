"""Port flash attention (veomni_tpu_torch/ops/cuda/flash_attention.py) vs the
JAX Pallas kernel.

The JAX side runs ``veomni_tpu.ops.pallas.flash_attention`` in interpret
mode on the CPU, as ``tests/test_flash_attention.py`` does; the port's
wrapper takes its plain version for CPU tensors. Tolerances are those of
``tests/test_flash_attention.py``: forward 2e-5, grads 5e-4 (f32).
The CUDA kernels themselves have no CPU mode: ``test_torch_cuda_kernels.py``
and ``chip_smoke.py`` hold them against this plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.ops.attention import _attention_xla as jax_attention_xla
from veomni_tpu.ops.pallas.flash_attention import _fwd as jax_fwd
from veomni_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from veomni_tpu_torch.ops.cuda import flash_attention as fa
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def _inputs(b=2, s=256, hq=4, hkv=2, d=32, seed=0, packed=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    if packed:
        seg[:, s // 3:] = 2
        seg[:, 2 * s // 3:] = 3
        seg[:, -7:] = 0  # trailing padding segment
    return q, k, v, seg


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_flash_matches_pallas(packed, causal):
    """Forward O and LSE (2e-5) and dQ/dK/dV (5e-4), GQA 4/2."""
    q, k, v, seg = _inputs(packed=packed)
    d = q.shape[-1]
    o_j, lse_j = jax_fwd(jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
                         jnp.asarray(seg), d ** -0.5, causal, 128, 128)
    o_t, lse_t = fa.flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v, seg)),
                                    d ** -0.5, causal)
    np.testing.assert_allclose(o_t.numpy(), np.swapaxes(np.asarray(o_j), 1, 2), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], rtol=2e-5, atol=2e-5)

    def loss_j(q, k, v):
        return (jax_flash(q, k, v, segment_ids=jnp.asarray(seg), causal=causal) ** 2).sum()

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fa.reset_counts()
    out = fa.flash_attention(qt, kt, vt, segment_ids=torch.from_numpy(seg), causal=causal)
    (out ** 2).sum().backward()
    assert fa.FALLBACK_CALLS == 0 and sum(fa.LAUNCHES.values()) == 0  # CPU: plain path
    for got, ref, name in zip((qt.grad, kt.grad, vt.grad), g_j, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-4,
                                   err_msg=f"grad d{name}")


def test_explicit_dispatch_rule_for_ragged_seq():
    """S % 128 != 0 dispatches to the plain ``_attention_xla`` (the
    reference's feature rule) and counts it in FALLBACK_CALLS."""
    q, k, v, seg = _inputs(s=100)
    fa.reset_counts()
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, seg)), causal=True)
    assert fa.FALLBACK_CALLS == 1
    ref = jax_attention_xla(q, k, v, segment_ids=jnp.asarray(seg), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout", [
    # (B, S, Hq, Hkv, split K2 is built for on 132 SMs)
    (4, 4096, 16, 8, 1),   # Qwen3-0.6B main path: 1024 items, the group of 2 in each
    (1, 4096, 32, 4, 4),   # Qwen3-30B-A3B at micro-batch 1 (its config's): 128 items, 512 split
    (4, 4096, 32, 4, 1),   # the MoE main path's micro-batch of 4: 512 items, no split
    (1, 512, 32, 4, 8),    # too few items for any split: the whole group of 8
    (1, 512, 4, 2, 2),
], ids=["dense", "moe-b1", "moe-b4", "small-gqa8", "small-gqa2"])
def test_dkv_group_split_rule(layout):
    """K2's q-head group split: the smallest divisor of the group that gives
    at least SPLIT_ITEMS_PER_SM work items per SM, the whole group if none
    does; the f32 workspace the wrapper allocates follows from it."""
    b, s, hq, hkv, want = layout
    split = fa.dkv_group_split(b, s, hq, hkv, 132)
    assert split == want
    assert (hq // hkv) % split == 0
    items = b * hkv * (s // fa.DKV_KEYS) * split
    assert items >= fa.SPLIT_ITEMS_PER_SM * 132 or split == hq // hkv
    shape = fa.dkv_workspace_shape(b, s, hkv, split)
    if split == 1:
        assert shape is None
    else:
        # dK's partials, then dV's: [2, split, B, S, Hkv, D] f32
        assert shape == (2, split, b, s, hkv, 128)
        assert np.prod(shape) * 4 == 2 * split * b * s * hkv * 128 * 4


@pytest.mark.parametrize("d", [64, 72, 256], ids=["d64", "d72", "d256"])
def test_plain_flash_matches_pallas_at_head_dims(d):
    """The head dims the kernels now take besides 128 (TinyLlama's 64,
    the Qwen3-VL tower's 72, Gemma-7B's 256): forward O and LSE (2e-5) and dQ/dK/dV (5e-4) of the
    plain version against the Pallas kernel in interpret mode, GQA 2/1."""
    q, k, v, seg = _inputs(b=1, s=256, hq=2, hkv=1, d=d, seed=d)
    o_j, lse_j = jax_fwd(jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
                         jnp.asarray(seg), d ** -0.5, True, 128, 128)
    o_t, lse_t = fa.flash_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v, seg)),
                                    d ** -0.5, True)
    np.testing.assert_allclose(o_t.numpy(), np.swapaxes(np.asarray(o_j), 1, 2), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], rtol=2e-5, atol=2e-5)

    def loss_j(q, k, v):
        return (jax_flash(q, k, v, segment_ids=jnp.asarray(seg), causal=True) ** 2).sum()

    g_j = jax.grad(loss_j, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (fa.flash_attention(qt, kt, vt, segment_ids=torch.from_numpy(seg)) ** 2).sum().backward()
    for got, ref, name in zip((qt.grad, kt.grad, vt.grad), g_j, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-4,
                                   err_msg=f"grad d{name}")


def test_kernel_domain_raises_naming_the_plain_pin():
    """Head dims outside 64/128/256 and non-bf16 inputs raise before any
    launch (the feature rule does not send them to the plain path), and the
    message names the ops_config pin to the plain attention."""
    q, k, v, seg = (torch.from_numpy(x) for x in _inputs(b=1, s=128, hq=2, hkv=1, d=96))
    with pytest.raises(ValueError, match="ops_config: {attention: xla}"):
        fa.flash_fwd_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16(), seg, 1.0, True, None)
    q, k, v, seg = (torch.from_numpy(x) for x in _inputs(b=1, s=128, hq=2, hkv=1, d=64))
    with pytest.raises(TypeError, match="ops_config: {attention: xla}"):
        fa.flash_fwd_cuda(q, k, v, seg, 1.0, True, None)


def test_dkv_group_split_counts_the_d256_halves():
    """At D = 256 K2 runs each key tile's dK/dV as two 128-column halves, so
    a batch has twice the work items, and its workspace is D wide."""
    assert fa.dkv_halves(256) == 2 and fa.dkv_halves(64) == fa.dkv_halves(128) == 1
    # 1 x 16 kv heads x 16 key tiles x 2 halves = 512 items: no split needed;
    # at D = 128, 256 items are fewer than 2 per SM: the group of 2 splits
    assert fa.dkv_group_split(1, 2048, 32, 16, 132, d=256) == 1
    assert fa.dkv_group_split(1, 2048, 32, 16, 132, d=128) == 2
    assert fa.dkv_workspace_shape(1, 1024, 16, 2, d=64) == (2, 2, 1, 1024, 16, 64)
