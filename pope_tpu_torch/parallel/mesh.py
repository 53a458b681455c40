"""The (dp, tp) device mesh and the sharding rules (port of
pope_tpu/parallel/mesh.py).

Axes:
  dp: data parallel (the pair / batch axis);
  tp: tensor parallel (output features), also the sequence-parallel axis
      of token-sharded batches.

`pope_tpu` annotates global arrays with a layout and lets XLA's SPMD
partitioner insert the collectives. Here a rank holds plain local tensors
(the kernels' `torch.ops.pope.*` have no DTensor sharding rule), and the
collectives are explicit: `shard_batch` cuts this rank's slice,
`shard_params_tp` keeps a layer's output-channel shard and gathers its
output over tp, so that every sharded forward equals the unsharded one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh

from pope_tpu_torch.parallel.collectives import all_gather, broadcast, enter_replicated, gather_replicated


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None) -> DeviceMesh:
    """A (dp, tp) DeviceMesh over the group's ranks (one device each).

    n_devices defaults to the world size and must equal it; tp defaults to
    2 when the count is even, else 1."""
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; this group has {world}")
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(n // tp, tp), mesh_dim_names=("dp", "tp"))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def is_mesh_main(mesh: DeviceMesh) -> bool:
    """This rank is rank 0 of the mesh's dp and tp axes: the one that
    writes a run's files."""
    return all(axis_rank(mesh, a) == 0 for a in ("dp", "tp") if a in mesh.mesh_dim_names)


def mesh_barrier(mesh: DeviceMesh) -> None:
    """Wait for every rank of the mesh's dp and tp axes (after the main
    rank has written a file that the others may read next)."""
    for a in ("dp", "tp"):
        if a in mesh.mesh_dim_names and axis_size(mesh, a) > 1:
            dist.barrier(group=mesh.get_group(a))


class ShardedBatch(dict):
    """shard_batch's result for a dict batch: this rank's slices, with the
    keys whose `sp_axis` was cut over tp (`split`)."""

    sp_axis: Optional[int] = None
    split: frozenset = frozenset()


def _slice(x, axis: int, rank: int, n: int):
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of size {size} does not divide over {n} ranks")
    step = size // n
    if torch.is_tensor(x):
        return x.narrow(axis, rank * step, step)
    index = [slice(None)] * x.ndim
    index[axis] = slice(rank * step, (rank + 1) * step)
    return x[tuple(index)]


def _sp_splits(x, sp_axis: Optional[int], tp: int) -> bool:
    return sp_axis is not None and x.ndim > sp_axis and x.shape[sp_axis] % tp == 0


def shard_batch(mesh: DeviceMesh, tree, sp_axis: Optional[int] = None):
    """This rank's slice of every array's leading axis over dp (and of axis
    `sp_axis` over tp, where it divides). A dict comes back as a
    ShardedBatch that names the keys cut over tp."""
    dp, tp = axis_size(mesh, "dp"), axis_size(mesh, "tp")
    dr, tr = axis_rank(mesh, "dp"), axis_rank(mesh, "tp")

    def put(x):
        x = _slice(x, 0, dr, dp)
        return _slice(x, sp_axis, tr, tp) if _sp_splits(x, sp_axis, tp) else x

    if isinstance(tree, dict):
        out = ShardedBatch({k: put(v) for k, v in tree.items()})
        out.sp_axis = sp_axis
        out.split = frozenset(k for k, v in tree.items() if _sp_splits(v, sp_axis, tp))
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(put(x) for x in tree)
    return put(tree)


def unshard_sp(mesh: DeviceMesh, batch: ShardedBatch) -> dict:
    """Gather the keys shard_batch cut over tp back to their full sp axis
    (the model needs every token); the dp slices stay."""
    group = mesh.get_group("tp")
    return {k: gather_replicated(v, group, batch.sp_axis) if k in batch.split else v
            for k, v in batch.items()}


@torch.no_grad()
def replicate(mesh: DeviceMesh, tree):
    """Rank 0's values on every rank: tensors come back as new tensors, a
    module's parameters and buffers are overwritten in place."""
    if isinstance(tree, nn.Module):
        for t in list(tree.parameters()) + list(tree.buffers()):
            t.copy_(broadcast(t))
        return tree
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return broadcast(tree) if torch.is_tensor(tree) else tree


@dataclasses.dataclass
class TPShard:
    """A layer that holds its rank's block of output features over the tp
    group: its input enters the replicated region (the
    backward sums the ranks' partial input gradients), a grouped conv keeps
    its groups' input channels, and its output is gathered over tp."""

    group: object
    in_slice: Optional[slice] = None  # input channels of a grouped conv's shard

    def enter(self, x, dim: int = 1):
        x = enter_replicated(x, self.group)
        if self.in_slice is not None:
            x = x.narrow(dim, self.in_slice.start, self.in_slice.stop - self.in_slice.start)
        return x

    def gather(self, y, dim: int):
        return gather_replicated(y, self.group, dim)


_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)


def tp_sharded(w: torch.Tensor, tp: int, min_size: int) -> bool:
    """pope_tpu's rule (on flax's (..., in, out) kernels): at least 2-D, at
    least min_size elements, output features divisible by tp. A torch
    weight keeps its output features in dim 0."""
    return w.ndim >= 2 and w.numel() >= min_size and w.shape[0] % tp == 0


@torch.no_grad()
def shard_params_tp(mesh: DeviceMesh, module: nn.Module, min_size: int = 1024, optimizer=None) -> nn.Module:
    """Tensor-parallel layout, in place: every Linear / Conv whose weight
    passes `tp_sharded` keeps its rows [r * out / tp, (r + 1) * out / tp)
    (and its bias's), and gathers its output over tp: forward hooks for
    module calls, and the layer's `tp_shard` for the model helpers that
    read the weight themselves (models/sam/encoder.py::tp_shard). Moments
    already in `optimizer`'s state are cut alike; moments made later take
    the shards' shape. Other tensors replicate."""
    tp = axis_size(mesh, "tp")
    if tp == 1:
        return module
    group, r = mesh.get_group("tp"), axis_rank(mesh, "tp")
    for layer in module.modules():
        if not isinstance(layer, (nn.Linear,) + _CONVS) or not tp_sharded(layer.weight, tp, min_size):
            continue
        out = layer.weight.shape[0]
        n = out // tp
        in_slice = None
        if isinstance(layer, _CONVS) and layer.groups > 1:
            if layer.groups % tp:
                continue
            cin = layer.in_channels // tp
            in_slice = slice(r * cin, (r + 1) * cin)
            layer.groups //= tp
            layer.in_channels = cin
        for p in (layer.weight, layer.bias):
            if p is None:
                continue
            state = optimizer.state.get(p, {}) if optimizer is not None else {}
            for k, v in state.items():
                if torch.is_tensor(v) and v.shape == p.shape:
                    state[k] = v[r * n:(r + 1) * n].clone()
            p.data = p.data[r * n:(r + 1) * n].clone()
            p.tp_sharded = True
        if isinstance(layer, _CONVS):
            layer.out_channels = n
        else:
            layer.out_features = n
        layer.tp_shard = TPShard(group, in_slice)
        dim = -1 if isinstance(layer, nn.Linear) else 1
        layer.register_forward_pre_hook(lambda m, args, d=dim: (m.tp_shard.enter(args[0], d),) + tuple(args[1:]))
        layer.register_forward_hook(lambda m, args, y, d=dim: m.tp_shard.gather(y, d))
    return module


@contextlib.contextmanager
def tp_gathered(module: nn.Module, optimizer=None):
    """Inside the block, the full tensors stand in place of the tp shards of
    `module`'s parameters and of their moments in `optimizer` (a
    checkpoint's view); every tp rank enters it. The shards come back on
    exit."""
    saved = []
    for layer in module.modules():
        shard = getattr(layer, "tp_shard", None)
        if shard is None:
            continue
        for p in (layer.weight, layer.bias):
            if p is None:
                continue
            state = optimizer.state.get(p, {}) if optimizer is not None else {}
            moments = {k: v for k, v in state.items() if torch.is_tensor(v) and v.shape == p.shape}
            saved.append((p, p.data, state, moments))
            p.data = all_gather(p.data, shard.group)
            for k, v in moments.items():
                state[k] = all_gather(v, shard.group)
    try:
        yield module
    finally:
        for p, data, state, moments in saved:
            p.data = data
            state.update(moments)
