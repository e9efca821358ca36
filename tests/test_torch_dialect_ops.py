"""The ops of the dense HF dialects (``veomni_tpu_torch/ops``) against the
JAX package's, on the CPU, f32, inputs from numpy seeds.

Tolerance rtol 1e-5 (atol 1e-5 where values cross zero): the rotary tables
for linear/llama3/yarn scaling, at Llama-3's theta 5e5 and positions up to
8191, full and partial width, and their application at a partial width
(an mrope section that does not cover the frequencies raises); the zero-centered RMSNorm (f32, and bf16
bit-equal); the exact and tanh GELU gated activations (the gpt_oss GLU is
``tests/test_torch_gpt_oss.py``'s; an unknown name raises);
``_attention_dense`` and ``_attention_xla_chunked`` with a sliding window,
packed segments and sinks (the chunked form with the gradients of q, k,
v), and ``_attention_xla`` on both sides of
``VEOMNI_ATTN_CHUNK_THRESHOLD``, set through the env knob; the chunked CE
with a logit softcap, with its gradients.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.models import TransformerConfig as JaxConfig
from veomni_tpu.models import transformer as jtf
from veomni_tpu.ops.cross_entropy import _flce_chunked as j_flce_chunked
from veomni_tpu.ops.rms_norm import _rms_norm_xla as j_rms_norm
from veomni_tpu.ops.rotary import _apply_rotary_xla as j_apply_rotary
from veomni_tpu.ops.rotary import rotary_tables as j_rotary_tables
from veomni_tpu_torch.ops.cross_entropy import fused_linear_cross_entropy
from veomni_tpu_torch.ops.rms_norm import rms_norm
from veomni_tpu_torch.ops.rotary import apply_rotary, rotary_tables
from veomni_tpu_torch.ops.swiglu import gated_act
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

# the modules (the packages' ``ops`` export functions of the same names)
j_attn = importlib.import_module("veomni_tpu.ops.attention")
t_attn = importlib.import_module("veomni_tpu_torch.ops.attention")
T = torch.from_numpy
RTOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, ref, rtol=RTOL, atol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
ROPE_SCALINGS = {
    "linear": {"rope_type": "linear", "factor": 4.0},
    "llama3": {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    "yarn": {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 4096,
             "beta_fast": 32, "beta_slow": 1},
    "yarn-mscale": {"type": "yarn", "factor": 40.0, "mscale": 1.0, "mscale_all_dim": 1.0,
                    "original_max_position_embeddings": 4096},
}


@pytest.mark.parametrize("rope_dim", [64, 32], ids=["full", "partial"])
@pytest.mark.parametrize("scaling", list(ROPE_SCALINGS))
def test_rotary_tables_with_scaling(scaling, rope_dim):
    """Positions up to 8191 at theta 5e5 (Llama-3's), so a frequency that
    came out one f32 ulp off would show in the angle."""
    pos = np.stack([np.arange(0, 8192, 64), np.arange(8191, 0, -64)]).astype(np.int32)
    cos_j, sin_j = j_rotary_tables(jnp.asarray(pos), rope_dim, 5e5,
                                   rope_scaling=ROPE_SCALINGS[scaling])
    cos_t, sin_t = rotary_tables(T(pos), rope_dim, 5e5, rope_scaling=ROPE_SCALINGS[scaling])
    assert cos_t.shape == (2, 128, rope_dim)
    _close(cos_t, cos_j)
    _close(sin_t, sin_j)


def test_partial_rotary_apply_and_mrope_raises():
    rng = _rng(1)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    cos, sin = rotary_tables(T(pos), 8, 1e4)
    cos_j, sin_j = j_rotary_tables(jnp.asarray(pos), 8, 1e4)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    qt, kt = apply_rotary(T(q), T(k), cos, sin)
    qr, kr = j_apply_rotary(q[..., :8], k[..., :8], cos_j, sin_j)
    _close(qt, np.concatenate([np.asarray(qr), q[..., 8:]], -1))
    _close(kt, np.concatenate([np.asarray(kr), k[..., 8:]], -1))
    # mrope is ported (the VLM models); a section that does not cover the
    # rotary frequencies raises, as in the reference
    with pytest.raises(ValueError, match="must sum to head_dim/2"):
        rotary_tables(T(np.stack([pos] * 3, 1)), 8, 1e4,
                      rope_scaling={"rope_type": "mrope", "mrope_section": [2, 1, 2]})


def test_rms_norm_zero_centered():
    rng = _rng(2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    w = rng.standard_normal(16).astype(np.float32) * 0.1
    _close(rms_norm(T(x), T(w), 1e-6, zero_centered=True),
           j_rms_norm(x, w, 1e-6, zero_centered=True), rtol=1e-6, atol=1e-6)
    # bf16: normalise and 1 + w in f32, one rounding at the end
    xb = torch.from_numpy(x).bfloat16()
    ref = j_rms_norm(jnp.asarray(xb.float().numpy(), jnp.bfloat16), w, 1e-6, zero_centered=True)
    got = rms_norm(xb, T(w), 1e-6, zero_centered=True)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("act", ["gelu_pytorch_tanh", "gelu", "silu"])
def test_gated_act(act):
    rng = _rng(3)
    g = rng.standard_normal((3, 7, 32)).astype(np.float32) * 4
    u = rng.standard_normal((3, 7, 32)).astype(np.float32)
    ref = jtf.gated_act(g, u, JaxConfig(hidden_act=act))
    _close(gated_act(T(g), T(u), act), ref, rtol=1e-6, atol=1e-6)


def test_gated_act_gpt_oss_raises():
    # the gpt_oss GLU is ported (tests/test_torch_gpt_oss.py); a name that
    # is no gated activation of the reference raises
    gated_act(torch.zeros(2), torch.zeros(2), "gpt_oss_glu")
    with pytest.raises(ValueError, match="gpt_oss_glu"):
        gated_act(torch.zeros(2), torch.zeros(2), "relu2")


def _qkv(seed, b, s, hq, hkv, d):
    rng = _rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv))


def _segments(b, s):
    seg = np.ones((b, s), np.int32)
    seg[:, s // 3:] = 2
    seg[:, -s // 8:] = 3
    return seg


@pytest.mark.parametrize("window", [None, 16, 200], ids=["full", "window16", "window200"])
@pytest.mark.parametrize("sinks", [False, True], ids=["nosinks", "sinks"])
def test_attention_dense_window_sinks(window, sinks):
    b, s, hq, hkv, d = 2, 96, 4, 2, 16
    q, k, v = _qkv(4, b, s, hq, hkv, d)
    seg = _segments(b, s)
    snk = _rng(5).standard_normal(hq).astype(np.float32) if sinks else None
    ref = j_attn._attention_dense(q, k, v, jnp.asarray(seg), True, 0.3, window,
                                  None if snk is None else jnp.asarray(snk))
    got = t_attn._attention_dense(T(q), T(k), T(v), T(seg), True, 0.3, window,
                                  None if snk is None else T(snk))
    _close(got, ref)


@pytest.mark.parametrize("window,causal", [(None, True), (100, True), (None, False)],
                         ids=["causal", "window100", "full"])
@pytest.mark.parametrize("sinks", [False, True], ids=["nosinks", "sinks"])
def test_attention_chunked_window_sinks(window, causal, sinks):
    """The blockwise form at S 384 over 128-token blocks (three q blocks,
    the diagonal skip and windows crossing block edges), values and the
    gradients of q, k, v against jax.grad of the reference's."""
    b, s, hq, hkv, d = 1, 384, 4, 2, 16
    q, k, v = _qkv(6, b, s, hq, hkv, d)
    seg = _segments(b, s)
    snk = _rng(7).standard_normal(hq).astype(np.float32) if sinks else None
    w = _rng(8).standard_normal((b, s, hq, d)).astype(np.float32)

    def j_loss(q_, k_, v_):
        out = j_attn._attention_xla_chunked(
            q_, k_, v_, jnp.asarray(seg), causal, None, window,
            None if snk is None else jnp.asarray(snk), q_chunk=128, k_chunk=128)
        return (out * w).sum(), out

    (_, ref), grads_j = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    qt, kt, vt = (T(x).requires_grad_() for x in (q, k, v))
    got = t_attn._attention_xla_chunked(qt, kt, vt, T(seg), causal, None, window,
                                        None if snk is None else T(snk), q_chunk=128,
                                        k_chunk=128)
    (got * T(w)).sum().backward()
    _close(got, ref)
    for g_t, g_j in zip((qt.grad, kt.grad, vt.grad), grads_j):
        _close(g_t, g_j, atol=1e-5 * float(np.abs(np.asarray(g_j)).max()))


@pytest.mark.parametrize("threshold", ["2048", "128"], ids=["dense", "chunked"])
def test_attention_xla_threshold_switch(threshold, monkeypatch):
    """``VEOMNI_ATTN_CHUNK_THRESHOLD`` below S sends both packages'
    ``_attention_xla`` to the blockwise form (S 384: three 128-token
    blocks), above it to the dense one."""
    monkeypatch.setenv("VEOMNI_ATTN_CHUNK_THRESHOLD", threshold)
    b, s, hq, hkv, d = 2, 384, 4, 1, 16
    q, k, v = _qkv(9, b, s, hq, hkv, d)
    seg = _segments(b, s)
    ref = j_attn._attention_xla(*map(jnp.asarray, (q, k, v, seg)), True, None, 64)
    got = t_attn._attention_xla(T(q), T(k), T(v), T(seg), True, None, 64)
    _close(got, ref)
    chunked = t_attn._attention_xla_chunked(T(q), T(k), T(v), T(seg), True, None, 64)
    dense = t_attn._attention_dense(T(q), T(k), T(v), T(seg), True, None, 64)
    np.testing.assert_array_equal(got.numpy(), (chunked if threshold == "128" else dense).numpy())


def test_chunked_flce_softcap():
    rng = _rng(10)
    t, h, vocab = 50, 16, 40
    hidden = rng.standard_normal((t, h)).astype(np.float32) * 3
    kernel = (rng.standard_normal((h, vocab)) * 0.5).astype(np.float32)
    labels = rng.integers(0, vocab, t).astype(np.int32)
    labels[::7] = -100

    def loss_j(hd, kn):
        return j_flce_chunked(hd, kn, jnp.asarray(labels), chunk_size=16, logit_softcap=5.0)

    ls_j, n_j = loss_j(hidden, kernel)
    g_j = jax.grad(lambda hd, kn: loss_j(hd, kn)[0], argnums=(0, 1))(hidden, kernel)
    ht, kt = T(hidden).requires_grad_(), T(kernel).requires_grad_()
    ls_t, n_t = fused_linear_cross_entropy(ht, kt, T(labels), chunk_size=16, logit_softcap=5.0)
    ls_t.backward()
    assert int(n_t) == int(n_j)
    np.testing.assert_allclose(ls_t.item(), float(ls_j), rtol=RTOL)
    _close(ht.grad, g_j[0])
    _close(kt.grad, g_j[1])
    uncapped, _ = fused_linear_cross_entropy(T(hidden), T(kernel), T(labels), chunk_size=16)
    assert abs(uncapped.item() - ls_t.item()) > 1.0  # the cap bites at these magnitudes
