"""Port ops (veomni_tpu_torch/ops) vs the JAX reference ops, f32 on the CPU.

Inputs are seeded numpy arrays fed to both packages. Tolerances: 1e-6 for
the elementwise ops (same f32 arithmetic), 2e-5 for attention and the
chunked CE (f32 matmul accumulation order differs between XLA and torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.ops.attention import _attention_dense as j_attention_dense
from veomni_tpu.ops.cross_entropy import _flce_chunked as j_flce_chunked
from veomni_tpu.ops.rms_norm import _rms_norm_xla as j_rms_norm
from veomni_tpu.ops.rotary import _apply_rotary_xla as j_apply_rotary
from veomni_tpu.ops.rotary import rotary_tables as j_rotary_tables
from veomni_tpu.ops.swiglu import _swiglu_xla as j_swiglu
from veomni_tpu_torch.ops.attention import _attention_dense, _attention_xla
from veomni_tpu_torch.ops.cross_entropy import fused_linear_cross_entropy
from veomni_tpu_torch.ops.rms_norm import rms_norm
from veomni_tpu_torch.ops.rotary import apply_rotary, rotary_tables
from veomni_tpu_torch.ops.swiglu import swiglu
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T = torch.from_numpy


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_rms_norm():
    rng = _rng()
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32)
    ref = j_rms_norm(x, w, 1e-6)
    got = rms_norm(T(x), T(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_rotary_tables_and_apply():
    rng = _rng(1)
    pos = np.stack([np.arange(40), np.r_[np.arange(25), np.arange(15)]]).astype(np.int32)
    cos_j, sin_j = j_rotary_tables(jnp.asarray(pos), 16, 1e6)
    cos_t, sin_t = rotary_tables(T(pos), 16, 1e6)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=1e-6, atol=1e-6)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    qj, kj = j_apply_rotary(q, k, cos_j, sin_j)
    qt, kt = apply_rotary(T(q), T(k), cos_t, sin_t)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-5, atol=1e-5)
    # mrope (ported with the VLM models): [B,3,S] positions, each frequency
    # from its section's stream, equal to the reference's tables
    pos3 = np.stack([pos, pos // 2, pos % 5], axis=1)
    rs = {"rope_type": "mrope", "mrope_section": [4, 2, 2]}
    cos_j, sin_j = j_rotary_tables(jnp.asarray(pos3), 16, 1e6, rope_scaling=rs)
    cos_t, sin_t = rotary_tables(T(pos3), 16, 1e6, rope_scaling=rs)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), rtol=1e-6, atol=1e-6)


def test_swiglu():
    rng = _rng(2)
    g = rng.standard_normal((3, 7, 32)).astype(np.float32) * 4
    u = rng.standard_normal((3, 7, 32)).astype(np.float32)
    np.testing.assert_allclose(swiglu(T(g), T(u)).numpy(),
                               np.asarray(j_swiglu(g, u)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_dense_packed_gqa(causal):
    rng = _rng(3)
    b, s, hq, hkv, d = 2, 48, 4, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    seg[:, 20:] = 2
    seg[:, -5:] = 0
    ref = j_attention_dense(q, k, v, jnp.asarray(seg), causal)
    got = _attention_dense(T(q), T(k), T(v), T(seg), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    via_xla = _attention_xla(T(q), T(k), T(v), segment_ids=T(seg), causal=causal)
    np.testing.assert_allclose(via_xla.numpy(), got.numpy(), rtol=0, atol=0)


def test_attention_dense_fully_masked_row_is_zero():
    """A row whose keys are all masked out (via mask_mod) emits 0, not a
    uniform average of V (reference attention.py:380-383)."""
    rng = _rng(4)
    b, s, h, d = 1, 16, 2, 8
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))

    def mask(qi, ki):  # rows 3 and 9 see nothing (works on jnp and torch grids)
        return (qi != 3) & (qi != 9) & (ki >= 0)

    ref = np.asarray(j_attention_dense(q, k, v, None, True, mask_mod=mask))
    got = _attention_dense(T(q), T(k), T(v), None, True, mask_mod=mask).numpy()
    assert np.all(got[:, [3, 9]] == 0)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_chunked_flce_matches_reference():
    """loss_sum / ntokens and the grads w.r.t. hidden and kernel, with
    ignored labels and a ragged last chunk."""
    rng = _rng(5)
    t, h, vocab = 50, 16, 40
    hidden = rng.standard_normal((t, h)).astype(np.float32)
    kernel = (rng.standard_normal((h, vocab)) * 0.3).astype(np.float32)
    labels = rng.integers(0, vocab, t).astype(np.int32)
    labels[::7] = -100

    def loss_j(hd, kn):
        return j_flce_chunked(hd, kn, jnp.asarray(labels), chunk_size=16)

    ls_j, n_j = loss_j(hidden, kernel)
    g_j = jax.grad(lambda hd, kn: loss_j(hd, kn)[0], argnums=(0, 1))(hidden, kernel)
    ht, kt = T(hidden).requires_grad_(), T(kernel).requires_grad_()
    ls_t, n_t = fused_linear_cross_entropy(ht, kt, T(labels), chunk_size=16)
    ls_t.backward()
    assert int(n_t) == int(n_j) == int((labels != -100).sum())
    np.testing.assert_allclose(ls_t.item(), float(ls_j), rtol=2e-6)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(g_j[0]), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(g_j[1]), rtol=2e-5, atol=2e-6)


def test_kernel_registry_gates_pins_and_force_eager(monkeypatch):
    """CPU tensors resolve to the plain impl (cuda_flash is gated to Hopper);
    a pin is an explicit request and wins; VEOMNI_FORCE_EAGER_OPS selects the
    plain impl; an unknown pin raises instead of falling back."""
    from veomni_tpu_torch.ops.cuda.flash_attention import flash_attention
    from veomni_tpu_torch.ops.kernel_registry import apply_ops_config, resolve_op

    cpu = torch.device("cpu")
    try:
        apply_ops_config(None)
        assert resolve_op("attention", cpu) is _attention_xla
        apply_ops_config({"attention": "cuda_flash"})
        assert resolve_op("attention", cpu) is flash_attention
        monkeypatch.setenv("VEOMNI_FORCE_EAGER_OPS", "1")
        apply_ops_config({"attention": "cuda_flash"})
        assert resolve_op("attention", cpu) is flash_attention  # the pin outranks the env
        apply_ops_config(None)
        assert resolve_op("attention", cpu) is _attention_xla
        apply_ops_config({"attention": "no_such_impl"})
        with pytest.raises(KeyError):
            resolve_op("attention", cpu)
    finally:
        apply_ops_config(None)
