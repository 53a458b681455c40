"""Collectives and rank helpers (port of pope_tpu/parallel/collectives.py;
reference src/utils/comm.py: get_world_size / get_rank / is_main_process,
all_gather, reduce_dict).

Under gloo a CUDA tensor is staged through pinned host memory on purpose:
gloo runs collectives on host buffers, and ranks that share one card use
gloo (parallel/launch.py). The choice follows from the group's backend and
the tensor's device, never from a caught error, and every staged byte is
counted in `STATS` beside the calls and their host milliseconds.

The differentiable forms come in two families, after what the ranks'
losses mean:
- data parallel (`sum_parts`, `gather_parts`): each rank's loss is its part
  of the global loss, which is their sum, and gradients are summed over the
  ranks. The backward of a sum is a sum, and that of a gather is a
  reduce-scatter (torch.distributed.nn.functional's semantics);
- replicated (`enter_replicated`, `gather_replicated`, `sum_replicated`):
  every rank computes the same loss from the same values (tensor and
  pipeline parallelism), so a gather's backward keeps this rank's slice and
  a sum's backward is the identity, while a replicated input's gradient
  sums the ranks' partial gradients (Megatron's f and g).
`ring_shift` is JAX's ppermute by one round the group, differentiable.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class CommStats:
    """Collectives run through this module: calls, host milliseconds (the
    enqueue under NCCL; copies and transfer under gloo) and bytes staged
    through host memory."""

    calls: int = 0
    ms: float = 0.0
    staged_bytes: int = 0

    def reset(self) -> None:
        self.calls, self.ms, self.staged_bytes = 0, 0.0, 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


STATS = CommStats()


def initialize_distributed(device=None, **kwargs):
    """Bring up torch.distributed through parallel/launch.py::initialize,
    for the topology resolve_env finds from kwargs (`coordinator`,
    `num_processes`, `process_id`) or the POPE_* / SLURM environment. A
    no-op returning None in a single process or when the process group
    already exists, as pope_tpu's jax.distributed wrapper is; else the
    Topology."""
    from pope_tpu_torch.parallel.launch import initialize, resolve_env

    if dist.is_initialized():
        return None
    env = resolve_env(**kwargs)
    if not env.is_multiprocess:
        return None
    return initialize(env, device)


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def group_rank(group=None) -> int:
    return dist.get_group_rank(group or dist.group.WORLD, dist.get_rank()) if dist.is_initialized() else 0


def group_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


class _Timed:
    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        STATS.calls += 1
        STATS.ms += (time.perf_counter() - self.t0) * 1e3


def _to_host(t: torch.Tensor) -> torch.Tensor:
    STATS.staged_bytes += t.numel() * t.element_size()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _from_host(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    STATS.staged_bytes += host.numel() * host.element_size()
    return host.to(like.device, non_blocking=True)


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction over the group, as a new tensor (no autograd)."""
    with _Timed():
        if _staged(t, group):
            host = _to_host(t.detach())
            dist.all_reduce(host, op=op, group=group)
            return _from_host(host, t)
        out = t.detach().clone()
        dist.all_reduce(out, op=op, group=group)
        return out


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The group's tensors (each of t's shape) concatenated along `dim` in
    group-rank order (no autograd)."""
    with _Timed():
        staged = _staged(t, group)
        src = _to_host(t.detach().contiguous()) if staged else t.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(group_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        return _from_host(out, t) if staged else out


@torch.no_grad()
def all_reduce_grads_(params, group=None, average: bool = False) -> None:
    """Sum (or average) the gradients of `params` over the group in one flat
    all-reduce, in place. Parameters without a gradient are skipped: every
    rank must have the same ones."""
    params = [p for p in params if p.grad is not None]
    flat = all_reduce(torch.cat([p.grad.reshape(-1).float() for p in params]), group)
    if average:
        flat /= group_size(group)
    for p, g in zip(params, torch.split(flat, [p.numel() for p in params])):
        p.grad = g.view_as(p).to(p.grad.dtype)


def broadcast(t: torch.Tensor, src_group_rank: int = 0, group=None) -> torch.Tensor:
    """Group rank `src_group_rank`'s tensor on every rank, as a new tensor."""
    src = dist.get_global_rank(group or dist.group.WORLD, src_group_rank)
    with _Timed():
        if _staged(t, group):
            host = _to_host(t.detach())
            dist.broadcast(host, src=src, group=group)
            return _from_host(host, t)
        out = t.detach().clone().contiguous()
        dist.broadcast(out, src=src, group=group)
        return out


def shift(t: torch.Tensor, group=None, offset: int = 1) -> torch.Tensor:
    """Send t to group rank (r + offset) % n and receive from (r - offset) %
    n (JAX's ppermute over a ring; no autograd)."""
    n = group_size(group)
    if n == 1:
        return t.detach().clone()
    r = group_rank(group)
    g = group or dist.group.WORLD
    dst = dist.get_global_rank(g, (r + offset) % n)
    src = dist.get_global_rank(g, (r - offset) % n)
    with _Timed():
        staged = _staged(t, group)
        send = _to_host(t.detach().contiguous()) if staged else t.detach().contiguous()
        recv = torch.empty_like(send)
        works = [dist.isend(send, dst, group=group), dist.irecv(recv, src, group=group)]
        for w in works:
            w.wait()
        return _from_host(recv, t) if staged else recv


# --- differentiable forms ---------------------------------------------------


class _SumParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _GatherParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return all_reduce(g, ctx.group).narrow(ctx.dim, r * ctx.n, ctx.n), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n).contiguous(), None, None


class _EnterReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return shift(x, group, offset)

    @staticmethod
    def backward(ctx, g):
        return shift(g.contiguous(), ctx.group, -ctx.offset), None, None


def sum_parts(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group; its gradient is summed over the group too."""
    return _SumParts.apply(x, group)


def gather_parts(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Concatenate the group's parts along `dim`; a rank's gradient is the
    sum of every rank's gradient of its slice (reduce-scatter)."""
    return _GatherParts.apply(x, group, dim)


def gather_replicated(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Concatenate the group's shards of a replicated computation along
    `dim`; the backward keeps this rank's slice."""
    return _GatherReplicated.apply(x, group, dim)


def enter_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity on a value every rank holds alike, whose gradient each rank
    computes in part: the backward sums the parts."""
    return _EnterReplicated.apply(x, group)


def sum_replicated(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group for a replicated computation: the backward is the
    identity."""
    return _SumReplicated.apply(x, group)


def ring_shift(x: torch.Tensor, group=None, offset: int = 1) -> torch.Tensor:
    """Differentiable ppermute by `offset` round the group."""
    return _RingShift.apply(x, group, offset)


# --- host-side helpers ------------------------------------------------------


def _comm_device(group=None) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_arrays(tree, group=None):
    """Gather every process's arrays (a dict / list / tuple of arrays or
    tensors of equal shapes on every rank) as numpy arrays stacked along a
    new leading process axis (multihost_utils.process_allgather)."""
    if get_world_size() == 1:
        return tree
    if isinstance(tree, dict):
        return {k: all_gather_arrays(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(all_gather_arrays(v, group) for v in tree)
    t = torch.as_tensor(np.asarray(tree.detach().cpu() if torch.is_tensor(tree) else tree))
    t = t.to(_comm_device(group))[None]
    return all_gather(t, group, 0).cpu().numpy()


def reduce_dict(metrics: Dict[str, Any], average: bool = True, group=None) -> Dict[str, Any]:
    """Mean (or sum) of scalar metric dicts over the processes, in float64."""
    if get_world_size() == 1:
        return metrics
    stacked = all_gather_arrays(
        {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float64) for k, v in metrics.items()},
        group,
    )
    op = np.mean if average else np.sum
    return {k: op(v, axis=0) for k, v in stacked.items()}


def psum_in_mesh(x: torch.Tensor, axis_name: str = "dp", mesh=None) -> torch.Tensor:
    """Gradient / metric all-reduce over one mesh axis (the DDP sum),
    differentiable."""
    return sum_parts(x, mesh.get_group(axis_name) if mesh is not None else None)


def gather_to_main(obj, group=None) -> Optional[List[Any]]:
    """Every group rank's picklable `obj`, in group-rank order, on group
    rank 0; None on the others."""
    if group_size(group) == 1:
        return [obj]
    dst = dist.get_global_rank(group or dist.group.WORLD, 0)
    out = [None] * group_size(group) if group_rank(group) == 0 else None
    with _Timed():
        dist.gather_object(obj, out, dst=dst, group=group)
    return out
