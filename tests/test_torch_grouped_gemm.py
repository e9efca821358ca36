"""Port grouped GEMM (veomni_tpu_torch/ops) vs the JAX reference, f32 on the CPU.

The plain versions of K4-K6 (``gmm_plain``, ``gmm_dlhs_plain``,
``gmm_t_plain``) against the Pallas kernels themselves (``_gmm_raw``,
``_gmm_dlhs``, ``_gmm_transpose``), which run in interpret mode on the CPU as
in ``tests/test_grouped_gemm.py``; the port's ragged impl and its autograd
Function (``cuda_group_gemm`` on CPU tensors takes the plain versions)
against ``_group_gemm_ragged`` (``jax.lax.ragged_dot``) and its gradients.
Cases: even groups, ragged with an empty expert, a single expert,
boundaries in the middle of a 128-row tile, and rows past the groups (which
every version writes as 0), at M=512, K=128, N=256, E=4; and a row count that
is not a multiple of 128.
Inputs are seeded numpy arrays fed to both packages. Tolerance (f32; the
two frameworks accumulate in other orders): each element within
``tol * |ref| + tol * max|ref|``, tol = 1e-5 for the products and 2e-4 for
the gradients of a squared loss (as the reference's own test holds them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veomni_tpu.ops.group_gemm import _group_gemm_ragged as j_ragged
from veomni_tpu.ops.pallas.grouped_gemm import (_gmm_dlhs, _gmm_raw, _gmm_transpose,
                                                _pallas_group_gemm)
from veomni_tpu_torch.ops import group_gemm
from veomni_tpu_torch.ops.cuda import grouped_gemm as gg
from veomni_tpu_torch.ops.group_gemm import _group_gemm_ragged
from veomni_tpu_torch.ops.kernel_registry import apply_ops_config
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

T = torch.from_numpy
CASES = {
    "even": [128, 128, 128, 128],
    "ragged-empty": [100, 156, 0, 256],
    "single": [512, 0, 0, 0],
    "mid-tile": [37, 219, 64, 192],
    "past-groups": [100, 0, 200, 0],  # rows 300..511 belong to no expert: 0
}


def _inputs(sizes, m=512, k=128, n=256, seed=0):
    rng = np.random.default_rng(seed)
    lhs = rng.standard_normal((m, k)).astype(np.float32)
    rhs = rng.standard_normal((len(sizes), k, n)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return lhs, rhs, g, np.asarray(sizes, np.int32), starts


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=tol, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("sizes", list(CASES.values()), ids=list(CASES))
def test_plain_versions_match_pallas_kernels(sizes):
    lhs, rhs, g, _, starts = _inputs(sizes)
    bm = bn = bk = 128
    _close(gg.gmm_plain(T(lhs), T(rhs), T(starts)), _gmm_raw(lhs, rhs, starts, bm, bn), 1e-5)
    _close(gg.gmm_dlhs_plain(T(g), T(rhs), T(starts)), _gmm_dlhs(g, rhs, starts, bm, bk), 1e-5)
    _close(gg.gmm_t_plain(T(lhs), T(g), T(starts), len(sizes)),
           _gmm_transpose(lhs, g, starts, len(sizes), bm, bk, bn), 1e-5)


@pytest.mark.parametrize("impl", ["cuda_gmm", "xla"], ids=["autograd-function", "ragged"])
@pytest.mark.parametrize("sizes", list(CASES.values()), ids=list(CASES))
def test_group_gemm_and_grads_match_ragged_dot(sizes, impl):
    """Forward, dlhs and drhs of a squared loss through the registry op with
    ``impl`` pinned, against ``ragged_dot`` and ``jax.grad``."""
    lhs, rhs, _, gs, _ = _inputs(sizes)

    def loss_j(a, b):
        return (j_ragged(a, b, jnp.asarray(gs)) ** 2).sum()

    ref = j_ragged(lhs, rhs, jnp.asarray(gs))
    d_lhs, d_rhs = jax.grad(loss_j, argnums=(0, 1))(lhs, rhs)
    a, b = T(lhs).requires_grad_(), T(rhs).requires_grad_()
    gg.reset_counts()
    apply_ops_config({"group_gemm": impl})
    try:
        out = group_gemm(a, b, T(gs).long())
        (out ** 2).sum().backward()
    finally:
        apply_ops_config(None)
    _close(out, ref, 1e-5)
    _close(a.grad, d_lhs, 2e-4)
    _close(b.grad, d_rhs, 2e-4)
    # the CPU path never counts a kernel launch
    assert gg.LAUNCHES == {"gmm_fwd": 0, "gmm_dlhs": 0, "gmm_t": 0}


def test_unaligned_shapes_take_the_ragged_path():
    """Ragged shapes: a row count M that is not a multiple of 128 goes
    through the autograd Function (on the card, the kernels mask the last
    row tile) and matches ragged_dot and its gradients; K or N not a
    multiple of 8 raises, on every device (a TMA row is a multiple of 16
    bytes), where the reference would take its plain ragged impl."""
    sizes = [37, 0, 219, 64]  # M = 320: the last 128-row tile holds 64 rows
    lhs, rhs, _, gs, _ = _inputs(sizes, m=sum(sizes))

    def loss_j(a, b):
        return (j_ragged(a, b, jnp.asarray(gs)) ** 2).sum()

    d_lhs, d_rhs = jax.grad(loss_j, argnums=(0, 1))(lhs, rhs)
    a, b = T(lhs).requires_grad_(), T(rhs).requires_grad_()
    out = gg.cuda_group_gemm(a, b, T(gs))
    (out ** 2).sum().backward()
    _close(out, j_ragged(lhs, rhs, jnp.asarray(gs)), 1e-5)
    _close(a.grad, d_lhs, 2e-4)
    _close(b.grad, d_rhs, 2e-4)
    for k, n in ((60, 256), (128, 100)):
        lhs, rhs, _, gs, _ = _inputs(sizes, m=sum(sizes), k=k, n=n)
        with pytest.raises(ValueError, match="multiples of 8"):
            gg.cuda_group_gemm(T(lhs), T(rhs), T(gs))


@pytest.mark.parametrize("kn", [(64, 256), (128, 96), (64, 776), (776, 64)],
                         ids=["k64", "n96", "k64-n776", "k776-n64"])
def test_unaligned_widths_match_the_reference_ragged_path(kn):
    """K or N a multiple of 8 but not of 128 (the reference CLI config's
    moe_intermediate_size 64; 776 = 6 x 128 + 8): the reference's op sends
    such shapes to its ragged path (``_pallas_group_gemm``, ``:266-269``);
    the port's op runs them in its kernels, whose plain versions (the CPU
    path of the autograd Function) match that path and its gradients."""
    k, n = kn
    sizes = [37, 0, 219, 64]
    lhs, rhs, _, gs, _ = _inputs(sizes, m=sum(sizes), k=k, n=n, seed=1)

    def loss_j(a, b):
        return (_pallas_group_gemm(a, b, jnp.asarray(gs)) ** 2).sum()

    ref = _pallas_group_gemm(lhs, rhs, jnp.asarray(gs))
    d_lhs, d_rhs = jax.grad(loss_j, argnums=(0, 1))(lhs, rhs)
    a, b = T(lhs).requires_grad_(), T(rhs).requires_grad_()
    gg.reset_counts()
    out = gg.cuda_group_gemm(a, b, T(gs))
    (out ** 2).sum().backward()
    assert gg.LAUNCHES == {"gmm_fwd": 0, "gmm_dlhs": 0, "gmm_t": 0}  # CPU: plain versions
    _close(out, ref, 1e-5)
    _close(a.grad, d_lhs, 2e-4)
    _close(b.grad, d_rhs, 2e-4)


def test_ragged_rows_past_the_groups_are_zero():
    """ragged_dot semantics for rows no group owns (sum(group_sizes) < M)."""
    lhs, rhs, _, _, _ = _inputs([128, 128, 128, 128])
    gs = np.asarray([100, 0, 200, 0], np.int32)
    got = _group_gemm_ragged(T(lhs), T(rhs), T(gs))
    _close(got, j_ragged(lhs, rhs, jnp.asarray(gs)), 1e-5)
    assert not got[300:].any()


def test_group_starts():
    sizes = torch.tensor([3, 0, 5, 0], dtype=torch.int64)
    starts = gg.group_starts(sizes)
    assert starts.dtype == torch.int32 and starts.tolist() == [0, 3, 3, 8, 8]
