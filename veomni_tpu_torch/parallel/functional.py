"""Differentiable collectives of the parallel layer.

The reference writes no collective: GSPMD inserts them, and JAX's AD
transposes each (``all_to_all`` into the reverse ``all_to_all``, ``psum``
into ``psum``, ``ppermute`` into the inverse permutation). Eager torch
needs each written with its backward, as a ``torch.autograd.Function``:

* :func:`all_reduce_sum` — forward sum, backward sum (the gradient of a
  value every rank reads is the sum of the ranks' gradients);
* :func:`all_to_all` — split one dim into the group's ranks, exchange,
  concatenate the received pieces on another dim; backward the reverse;
* :func:`all_gather` — concatenate every rank's tensor on a dim; backward
  the reduce-scatter (sum) of the gradient;
* :func:`send_recv` — the ring's rotation, no gradient (the ring's own
  backward rotates the gradients, ``parallel/ring_attention.py``).

A group of ``None`` is one rank: every function is then the identity.

Two ranks that share one card talk over gloo (NCCL keeps one rank a
device). Gloo takes CUDA tensors for the reduction, gather, scatter and
all-to-all collectives but not for ``isend``/``irecv``, which fail with
``Bad address`` (``tools/collective_probe.py`` on the H100, torch 2.11);
:func:`send_recv` copies through host memory for such a group.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


#: send_recv calls staged through host memory (gloo takes no isend/irecv of
#: a CUDA tensor): a transport that is named, never silent
HOST_STAGED_CALLS = 0


def _host_staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group, on every rank, with a gradient."""
    if group is None:
        return x
    if not x.requires_grad:
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out
    return _AllReduceSum.apply(x, group)


def _a2a(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size {x.shape[split_dim]} "
                         f"does not split over {n} ranks")
    # the pieces, destination-major, in one contiguous buffer
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[r] is source rank r's piece: concatenate in rank order
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        group, split_dim, concat_dim = ctx.args
        return _a2a(grad, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Rank r sends the j-th of ``n`` chunks of ``x`` along ``split_dim`` to
    rank j and concatenates what it receives along ``concat_dim`` in source
    rank order; the gradient takes the reverse exchange."""
    if group is None:
        return x
    if not x.requires_grad:
        return _a2a(x, group, split_dim, concat_dim)
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        group, dim = ctx.args
        return _reduce_scatter(grad, group, dim), None, None


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    gradient is reduce-scattered (summed) back to each rank's slice."""
    if group is None:
        return x
    if not x.requires_grad:
        return _gather(x, group, dim)
    return _AllGather.apply(x, group, dim)


def send_recv(tensors: List[torch.Tensor], group, dst: int, src: int) -> List[torch.Tensor]:
    """Send ``tensors`` to group rank ``dst`` and receive same-shaped ones
    from group rank ``src`` (one ring rotation)."""
    global HOST_STAGED_CALLS
    staged = _host_staged(group, tensors[0])
    HOST_STAGED_CALLS += staged
    outs = [torch.empty(t.shape, dtype=t.dtype, device="cpu" if staged else t.device)
            for t in tensors]
    ops = []
    gdst = dist.get_global_rank(group, dst)
    gsrc = dist.get_global_rank(group, src)
    for t, o in zip(tensors, outs):
        send = t.detach().cpu().contiguous() if staged else t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, send, gdst, group=group))
        ops.append(dist.P2POp(dist.irecv, o, gsrc, group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        outs = [o.to(t.device, non_blocking=False) for o, t in zip(outs, tensors)]
    return outs


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (the rank-0 verdicts); the identity
    without a process group."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return obj
    box: List[Optional[object]] = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
