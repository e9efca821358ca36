"""Grouped GEMM on Hopper: CUDA C++ kernels K4-K6 + their plain versions.

Port of ``veomni_tpu/ops/pallas/grouped_gemm.py``. The kernels live in
``veomni_tpu_torch/csrc/grouped_gemm.cu`` (its header says what bounds them
on the H100 and how the design answers it):

* K4 ``vt_gmm_fwd``  <- ``_gmm_kernel``      (reference ``:37-61``, ``_gmm_raw`` ``:79``)
* K5 ``vt_gmm_dlhs`` <- ``_gmm_dlhs_kernel`` (``:104-130``, ``_gmm_dlhs`` ``:133``)
* K6 ``vt_gmm_t``    <- ``_gmm_t_kernel``    (``:166-190``, ``_gmm_transpose`` ``:193``)

K4 and K5 are one Hopper kernel template: TMA loads into a ring of
128-byte-swizzled shared-memory stages completed on mbarriers, ``wgmma``
from two consumer warpgroups (128 x 256 output tiles, 128 x 128 where the
output width is not a multiple of 256) fed by one producer thread, one
expert at a time per tile with an epilogue that writes only that expert's
rows (rows no expert owns are written as 0), and a persistent schedule of
one block per SM. K6 is built the same way: a tile is 128 K rows x 256 (or
128) N columns of one expert's drhs, the mainloop runs over the expert's
rows in 64-row chunks (both operands MN-major), the rows of the next
expert in its last chunk are zeroed in the lhs stage, an empty expert's
tiles are written as zeros, and the staged TMA-store epilogue overlaps the
next tile's mainloop. The C entry points encode the tensor maps per call
(``csrc/hopper.cuh`` holds the shared TMA, mbarrier and ``wgmma`` helpers).

Beside each kernel sits its plain PyTorch version (``gmm_plain``,
``gmm_dlhs_plain``, ``gmm_t_plain``) with the same inputs and outputs. A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. ``LAUNCHES`` counts kernel
launches, one per launch. The kernel wrappers never read a device value on
the host: the group starts go to the kernels as a device pointer (only the
plain versions read them on the host).

``cuda_group_gemm`` (registered as ``group_gemm``/``cuda_gmm``) takes any
row count M: the kernels mask the last row tile. K and N must be multiples
of 8 (TMA's 16-byte row rule), on every device; other widths raise
``ValueError``. Widths that are not a multiple of the kernels' tiles (the
reference's ragged-path shapes, ``:266-269``) run in the kernels: TMA reads
zeros past a tensor's edge and does not store past it. Its autograd
Function is the reference's ``custom_vjp`` (``:222-240``): forward K4;
backward K5 (dlhs) and K6 (drhs).

Numerics. Products of bf16 operands are exact in f32, and every kernel
accumulates in f32 and rounds its output to bf16 once, as the plain
versions do: they agree up to the f32 summation order, i.e. an output may
land on the neighbouring bf16 value.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from veomni_tpu_torch.observability import cost
from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY

SOURCE = "grouped_gemm.cu"
ALIGN = 8  # K and N must be multiples of it (16 bytes of bf16: TMA's row rule)

LAUNCHES = {"gmm_fwd": 0, "gmm_dlhs": 0, "gmm_t": 0}

_COUNT_LOCK = threading.Lock()


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def group_starts(group_sizes: torch.Tensor) -> torch.Tensor:
    """[E+1] int32 prefix sum of the group sizes (starts[0] = 0), on their device."""
    sizes = group_sizes.to(torch.int32)
    return torch.cat([sizes.new_zeros(1), torch.cumsum(sizes, 0, dtype=torch.int32)])


# --------------------------------------------------------------------------
# Plain versions (the CPU path and the on-card reference for the kernels)
# --------------------------------------------------------------------------
def _bounds(starts):
    s = starts.tolist()  # host read: the plain versions only
    return [(e, s[e], s[e + 1]) for e in range(len(s) - 1) if s[e + 1] > s[e]]


def gmm_plain(lhs, rhs, starts):
    """K4: out [M,N] in lhs' dtype; row r of expert e is lhs[r] @ rhs[e]."""
    out = lhs.new_zeros((lhs.shape[0], rhs.shape[2]))
    for e, s, t in _bounds(starts):
        out[s:t] = (lhs[s:t].float() @ rhs[e].float()).to(lhs.dtype)
    return out


def gmm_dlhs_plain(g, rhs, starts):
    """K5: dlhs [M,K] in g's dtype; row r of expert e is g[r] @ rhs[e]^T."""
    out = g.new_zeros((g.shape[0], rhs.shape[1]))
    for e, s, t in _bounds(starts):
        out[s:t] = (g[s:t].float() @ rhs[e].float().t()).to(g.dtype)
    return out


def gmm_t_plain(lhs, g, starts, num_experts: int):
    """K6: drhs [E,K,N] in lhs' dtype; drhs[e] = lhs[rows of e]^T @ g[rows of e],
    zero for an empty expert."""
    out = lhs.new_zeros((num_experts, lhs.shape[1], g.shape[1]))
    for e, s, t in _bounds(starts):
        out[e] = (lhs[s:t].float().t() @ g[s:t].float()).to(lhs.dtype)
    return out


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _lib() -> ctypes.CDLL:
    from veomni_tpu_torch.ops.cuda.build import load

    lib = load(SOURCE)
    if not getattr(lib, "_vt_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.vt_gmm_fwd, lib.vt_gmm_dlhs, lib.vt_gmm_t):
            fn.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
            fn.restype = ctypes.c_int
        lib.vt_gmm_align.argtypes = []
        lib.vt_gmm_align.restype = ctypes.c_int
        if lib.vt_gmm_align() != ALIGN:
            raise RuntimeError(f"{SOURCE} takes widths in multiples of {lib.vt_gmm_align()}, "
                               f"the wrapper checks {ALIGN}")
        lib._vt_typed = True
    return lib


def _check_widths(k: int, n: int) -> None:
    if k % ALIGN or n % ALIGN:
        raise ValueError(f"grouped GEMM takes K and N multiples of {ALIGN} (a TMA row is a "
                         f"multiple of 16 bytes); got K={k} N={n}")


def _check(a, b, starts, m: int, k: int, n: int, num_experts: int):
    """Raise on anything the kernels do not take."""
    _check_widths(k, n)
    if m <= 0:
        raise ValueError(f"grouped GEMM kernels take M > 0; got M={m}")
    for t in (a, b):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"grouped GEMM kernels take bfloat16, got {t.dtype}")
    if starts.dtype != torch.int32 or tuple(starts.shape) != (num_experts + 1,):
        raise TypeError(f"group starts must be int32 [E+1] = [{num_experts + 1}], "
                        f"got {starts.dtype} {tuple(starts.shape)}")
    for t in (a, b, starts):
        if not t.is_cuda or t.device != a.device:
            raise ValueError("grouped GEMM kernels: all tensors must be on the same CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("grouped GEMM kernels take contiguous, 16-byte aligned tensors")


def _launch(name: str, tensors, m: int, k: int, n: int, num_experts: int) -> None:
    """Launch ``vt_<name>`` on the current stream, raise on a CUDA error,
    count the launch."""
    err = getattr(_lib(), "vt_" + name)(
        *(t.data_ptr() for t in tensors), m, k, n, num_experts,
        torch.cuda.current_stream(tensors[0].device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    with _COUNT_LOCK:  # serving replicas launch from threads of their own
        LAUNCHES[name] += 1
    cost.note_kernel(lambda: gmm_work(name, m, k, n, num_experts, tensors[2]))


def gmm_work(name: str, m: int, k: int, n: int, num_experts: int, starts):
    """(FLOPs, bytes) of one K4/K5/K6 launch, the formulas of the Bound
    column of PERF.md's kernel table: 2 M K N FLOPs; bf16 operands read
    once (K4/K5 read only the experts that own rows), the output written
    once, the i32 group starts."""
    used = int(((starts[1:] - starts[:-1]) > 0).sum())
    weights = (num_experts if name == "gmm_t" else used) * k * n * 2
    nbytes = (m * k + m * n) * 2 + weights + (num_experts + 1) * 4
    return 2.0 * m * k * n, nbytes


def gmm_cuda(lhs, rhs, starts):
    """K4: out [M,N] bf16 from lhs [M,K], rhs [E,K,N], starts [E+1]."""
    (m, k), (e, _, n) = lhs.shape, rhs.shape
    _check(lhs, rhs, starts, m, k, n, e)
    if rhs.shape[1] != k:
        raise ValueError(f"gmm: lhs {tuple(lhs.shape)} / rhs {tuple(rhs.shape)} mismatch")
    out = torch.empty((m, n), dtype=lhs.dtype, device=lhs.device)
    _launch("gmm_fwd", (lhs, rhs, starts, out), m, k, n, e)
    return out


def gmm_dlhs_cuda(g, rhs, starts):
    """K5: dlhs [M,K] bf16 from g [M,N], rhs [E,K,N], starts [E+1]."""
    (m, n), (e, k, _) = g.shape, rhs.shape
    _check(g, rhs, starts, m, k, n, e)
    if rhs.shape[2] != n:
        raise ValueError(f"gmm_dlhs: g {tuple(g.shape)} / rhs {tuple(rhs.shape)} mismatch")
    out = torch.empty((m, k), dtype=g.dtype, device=g.device)
    _launch("gmm_dlhs", (g, rhs, starts, out), m, k, n, e)
    return out


def gmm_t_cuda(lhs, g, starts, num_experts: int):
    """K6: drhs [E,K,N] bf16 from lhs [M,K], g [M,N], starts [E+1]."""
    (m, k), n = lhs.shape, g.shape[1]
    _check(lhs, g, starts, m, k, n, num_experts)
    if g.shape[0] != m:
        raise ValueError(f"gmm_t: lhs {tuple(lhs.shape)} / g {tuple(g.shape)} mismatch")
    out = torch.empty((num_experts, k, n), dtype=lhs.dtype, device=lhs.device)
    _launch("gmm_t", (lhs, g, starts, out), m, k, n, num_experts)
    return out


def gmm(lhs, rhs, starts):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    return gmm_cuda(lhs, rhs, starts) if lhs.is_cuda else gmm_plain(lhs, rhs, starts)


def gmm_dlhs(g, rhs, starts):
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    return gmm_dlhs_cuda(g, rhs, starts) if g.is_cuda else gmm_dlhs_plain(g, rhs, starts)


def gmm_t(lhs, g, starts, num_experts: int):
    """K6 on CUDA tensors, its plain version on CPU tensors."""
    if lhs.is_cuda:
        return gmm_t_cuda(lhs, g, starts, num_experts)
    return gmm_t_plain(lhs, g, starts, num_experts)


class _GroupGemm(torch.autograd.Function):
    """Forward K4; backward K5 (dlhs) and K6 (drhs), the reference's
    ``custom_vjp`` (``:222-240``). Saves lhs, rhs and the group starts."""

    @staticmethod
    def forward(ctx, lhs, rhs, starts):
        ctx.save_for_backward(lhs, rhs, starts)
        return gmm(lhs, rhs, starts)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, starts = ctx.saved_tensors
        g = g.contiguous()
        dlhs = gmm_dlhs(g, rhs, starts).to(lhs.dtype) if ctx.needs_input_grad[0] else None
        drhs = (gmm_t(lhs, g, starts, rhs.shape[0]).to(rhs.dtype)
                if ctx.needs_input_grad[1] else None)
        return dlhs, drhs, None


@KERNEL_REGISTRY.register(
    "group_gemm", "cuda_gmm", device_types=("cuda",), priority=10, min_sm=(9, 0)
)
def cuda_group_gemm(tokens, weights, group_sizes):
    """tokens [M,K] sorted by expert; weights [E,K,N]; group_sizes [E] -> [M,N]
    (reference ``_pallas_group_gemm``, ``:258-273``). Any M; K and N
    multiples of 8."""
    _check_widths(tokens.shape[1], weights.shape[2])
    return _GroupGemm.apply(tokens.contiguous(), weights.contiguous(), group_starts(group_sizes))
