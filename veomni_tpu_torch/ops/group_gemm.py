"""Grouped GEMM for fused MoE experts (port of ``veomni_tpu/ops/group_gemm.py``).

The plain ragged impl ``_group_gemm_ragged`` (registered as
``group_gemm``/``xla_ragged`` and ``xla``, the reference's names) computes
``jax.lax.ragged_dot`` with f32 accumulation: tokens pre-sorted by expert,
``group_sizes[e]`` tokens per expert. The Hopper kernels register as
``cuda_gmm`` in ``ops/cuda/grouped_gemm.py``.
"""

from __future__ import annotations

import torch

from veomni_tpu_torch.ops.kernel_registry import KERNEL_REGISTRY, resolve_op


@KERNEL_REGISTRY.register("group_gemm", "xla_ragged")
def _group_gemm_ragged(tokens, weights, group_sizes):
    """tokens [M,K] sorted by expert; weights [E,K,N]; group_sizes [E] -> [M,N]
    in tokens' dtype, each product accumulated in f32. Rows past
    ``sum(group_sizes)`` are 0, as in ``ragged_dot``. Reads the group sizes
    on the host: this is the plain path."""
    m, n = tokens.shape[0], weights.shape[2]
    ends = torch.cumsum(group_sizes.to(torch.int64), 0).clamp(max=m).tolist()
    pieces, start = [], 0
    for e, end in enumerate(ends):
        pieces.append(tokens[start:end].float() @ weights[e].float())
        start = end
    pieces.append(tokens.new_zeros((m - start, n), dtype=torch.float32))
    return torch.cat(pieces).to(tokens.dtype)


# the reference's alias, so VEOMNI_FORCE_EAGER_OPS and "xla" pins reach it
KERNEL_REGISTRY.register("group_gemm", "xla")(_group_gemm_ragged)


def group_gemm(tokens, weights, group_sizes):
    return resolve_op("group_gemm", tokens.device)(tokens, weights, group_sizes)
