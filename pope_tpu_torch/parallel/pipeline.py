"""GPipe-style pipeline parallelism over a `pp` mesh axis (port of
pope_tpu/parallel/pipeline.py).

Each pp rank holds ONE stage of a homogeneous stack (a parameter dict with
a leading stage axis, cut over pp). Microbatches flow rank to rank by a
differentiable ring shift: n_micro + S - 1 steps, the first microbatch as
the placeholder that fills the bubble, the last rank collecting the
outputs, and one sum that replicates them over pp.

Every rank builds the same autograd graph (its choices are masks, not
branches: rank 0's received value and the other ranks' collected outputs
enter with weight 0), so that the ring shifts' backward sends and receives
line up on every rank. The loss is computed alike on every rank from the
replicated output; a parameter's gradient lands on the rank of its stage.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from pope_tpu_torch.parallel.collectives import all_reduce, gather_replicated, ring_shift, sum_replicated
from pope_tpu_torch.parallel.mesh import axis_rank, axis_size


def stack_stage_params(params_list):
    """S parameter dicts of one structure -> one dict with a leading (S,
    ...) stage axis."""
    return {k: torch.stack([p[k] for p in params_list]) for k in params_list[0]}


def shard_stage_params(stacked: Dict[str, torch.Tensor], mesh: DeviceMesh, axis: str = "pp"):
    """This rank's part of the stage axis (leading axis cut over `axis`), as
    leaf tensors that take gradients."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    out = {}
    for k, v in stacked.items():
        if v.shape[0] % n:
            raise ValueError(f"{v.shape[0]} stages do not divide over the {n} '{axis}' ranks")
        per = v.shape[0] // n
        out[k] = v[r * per:(r + 1) * per].detach().clone().requires_grad_(True)
    return out


def pipeline_apply(stage_fn: Callable, mesh: DeviceMesh, axis: str = "pp", batch_axis: Optional[str] = None):
    """Build a pipelined apply: (this rank's stage params, x (n_micro, mb,
    ...)) -> y (n_micro, mb, ...), replicated over `axis`.

    stage_fn(params, x) must keep the activation's shape, and be total on
    any finite input: in the fill / drain bubble a rank works on the first
    microbatch's values, and its outputs are dropped. x is the whole input
    on every rank; with `batch_axis` each of its ranks takes its slice of
    the microbatch axis and y is gathered back over it. The local stage
    axis must hold exactly one stage: one stage per rank."""
    S = axis_size(mesh, axis)
    rank = axis_rank(mesh, axis)
    group = mesh.get_group(axis)

    def call(params, x):
        n_local = next(iter(params.values())).shape[0]
        if n_local != 1:
            raise ValueError(
                f"stacked parameter tree has {n_local * S} stages but the '{axis}' mesh axis has {S} ranks "
                "- the pipeline maps exactly one stage per rank (fold multiple blocks into one stage_fn to "
                "run deeper models)"
            )
        if batch_axis is not None:
            nb, rb = axis_size(mesh, batch_axis), axis_rank(mesh, batch_axis)
            mb = x.shape[1] // nb
            x = x[:, rb * mb:(rb + 1) * mb]
        p = {k: v[0] for k, v in params.items()}
        n_micro = x.shape[0]
        steps = n_micro + S - 1
        first = torch.tensor(rank == 0, device=x.device)
        last = rank == S - 1
        recv = x[0]
        outs = [torch.zeros_like(x[0]) for _ in range(n_micro)]
        for t in range(steps):
            inp = torch.where(first, x[min(t, n_micro - 1)], recv)
            out = stage_fn(p, inp)
            if t < steps - 1:  # no trailing send: its result would be dropped
                recv = ring_shift(out, group)
            # the last rank emits microbatch t - (S - 1) at step t
            slot = min(max(t - (S - 1), 0), n_micro - 1)
            take = torch.tensor(last and t >= S - 1, device=x.device)
            outs[slot] = torch.where(take, out, outs[slot])
        y = torch.stack(outs) * float(last)
        y = sum_replicated(y, group)
        if batch_axis is not None:
            y = gather_replicated(y, mesh.get_group(batch_axis), 1)
        return y

    return call


def pipeline_loss_and_grad(stage_fn: Callable, loss_fn: Callable, mesh: DeviceMesh, axis: str = "pp",
                           batch_axis: Optional[str] = None):
    """(this rank's stage params, x, y_target) -> (loss, grads): one loss over
    the whole output, differentiated through the schedule; the gradients
    come back in the params' local layout (summed over `batch_axis`)."""
    apply = pipeline_apply(stage_fn, mesh, axis, batch_axis)

    def run(params, x, y):
        params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(apply(params, x), y)
        grads = torch.autograd.grad(loss, list(params.values()))
        if batch_axis is not None:
            grads = [all_reduce(g, mesh.get_group(batch_axis)) for g in grads]
        return loss.detach(), dict(zip(params, grads))

    return run
