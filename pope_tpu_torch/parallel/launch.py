"""Multi-process launch (port of pope_tpu/parallel/launch.py): the bootstrap
ladder (explicit args > preset POPE_* env > SLURM allocation > local), the
process group, and the entry contract of `launch`.

One `pope_tpu` process drives every chip of its host; here one process
drives one device, so a host with N ranks runs N processes. `spawn` starts
them on one host with no launcher (`cli eval --dp N`, `train-ssl --dp N`).

The backend is fixed once, before the group exists, and printed: NCCL when
every rank on its host has a card of its own, gloo when ranks share a card
or run on the CPU (NCCL refuses two ranks of one communicator on one
device). Nothing falls back to another backend after an error.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import socket
from typing import Callable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

# SLURM's compact nodelist syntax: "tpu-[001-003,007],login1"
_NODELIST_GROUP = re.compile(r"([^,\[]+)(?:\[([^\]]+)\])?")


def parse_slurm_nodelist(nodelist: str) -> list[str]:
    """Expand a SLURM compact nodelist into hostnames.

    Handles prefix[a-b,c] ranges with zero padding and plain comma-joined
    names (dinov2/distributed/__init__.py _parse_slurm_node_list semantics).
    """
    hosts: list[str] = []
    pos = 0
    while pos < len(nodelist):
        m = _NODELIST_GROUP.match(nodelist, pos)
        if not m:
            raise ValueError(f"unparseable SLURM nodelist at {nodelist[pos:]!r}")
        prefix, body = m.group(1), m.group(2)
        if body is None:
            hosts.append(prefix)
        else:
            for part in body.split(","):
                if "-" in part:
                    lo, hi = part.split("-")
                    width = len(lo)
                    for i in range(int(lo), int(hi) + 1):
                        hosts.append(f"{prefix}{i:0{width}d}")
                else:
                    hosts.append(f"{prefix}{part}")
        pos = m.end()
        if pos < len(nodelist):
            if nodelist[pos] != ",":
                raise ValueError(f"unparseable SLURM nodelist at {nodelist[pos:]!r}")
            pos += 1
    return hosts


def _slurm_port(job_id: int) -> int:
    # deterministic per-job port in the dynamic range so every process picks
    # the same coordinator port without a rendezvous file
    return 20000 + job_id % 20000


_PRESET_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


@dataclasses.dataclass(frozen=True)
class DistributedEnv:
    """Resolved process topology."""

    coordinator_address: Optional[str]  # "host:port" (or "file:///path"); None => auto-detect
    num_processes: Optional[int]
    process_id: Optional[int]
    source: str  # 'explicit' | 'preset-env' | 'slurm' | 'local'

    @property
    def is_multiprocess(self) -> bool:
        return (self.num_processes or 1) > 1


def resolve_env(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    environ: Optional[Mapping[str, str]] = None,
) -> DistributedEnv:
    """Bootstrap ladder: explicit args > POPE_* preset env > SLURM > local.

    A partially set preset environment, or explicit multi-process intent
    with a missing value, is an error; an explicit single process with no
    coordinator is a local run.
    """
    env = os.environ if environ is None else environ
    if coordinator is None and num_processes == 1 and process_id in (None, 0):
        # a fully single-process explicit spec is just a local run: don't
        # spin up the distributed runtime for `--num-processes 1`
        return DistributedEnv(None, None, None, "local")
    if coordinator is not None or num_processes is not None or process_id is not None:
        # any multi-process intent (num_processes > 1 OR a process_id) needs
        # all three values; a lone coordinator stays legal
        if ((num_processes or 1) > 1 or process_id is not None) and (
            coordinator is None or num_processes is None or process_id is None
        ):
            missing = [
                name
                for name, val in (
                    ("coordinator", coordinator),
                    ("num_processes", num_processes),
                    ("process_id", process_id),
                )
                if val is None
            ]
            raise RuntimeError(
                f"partially specified explicit distributed topology; missing {missing}"
            )
        return DistributedEnv(coordinator, num_processes, process_id, "explicit")

    preset = {v: env[f"POPE_{v}"] for v in _PRESET_VARS if f"POPE_{v}" in env}
    if preset:
        if len(preset) != len(_PRESET_VARS):
            missing = [v for v in _PRESET_VARS if v not in preset]
            raise RuntimeError(
                f"partially set POPE_* distributed environment; missing {missing}"
            )
        return DistributedEnv(
            preset["COORDINATOR_ADDRESS"],
            int(preset["NUM_PROCESSES"]),
            int(preset["PROCESS_ID"]),
            "preset-env",
        )

    if "SLURM_JOB_ID" in env and "SLURM_NTASKS" in env:
        ntasks = int(env["SLURM_NTASKS"])
        if ntasks > 1:
            nodes = parse_slurm_nodelist(env["SLURM_JOB_NODELIST"])
            port = _slurm_port(int(env["SLURM_JOB_ID"]))
            return DistributedEnv(
                f"{nodes[0]}:{port}",
                ntasks,
                int(env["SLURM_PROCID"]),
                "slurm",
            )

    return DistributedEnv(None, None, None, "local")


@dataclasses.dataclass(frozen=True)
class Topology:
    """What `initialize` decided: this rank's place on its host and the
    backend every rank uses."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    backend: str  # 'nccl' | 'gloo'
    device: torch.device


def _store(env: DistributedEnv, rank: int, world: int):
    addr = env.coordinator_address
    if addr is None:
        raise RuntimeError(f"a {world}-process run needs a coordinator address (source {env.source})")
    if addr.startswith("file://"):
        return dist.FileStore(addr[len("file://"):], world)
    host, port = addr.rsplit(":", 1)
    return dist.TCPStore(host, int(port), world, is_master=rank == 0)


def initialize(env: Optional[DistributedEnv] = None, device=None) -> Topology:
    """Bring up the default process group for the resolved topology.

    The ranks meet in a store at the coordinator (`tcp://host:port`, or a
    `file://` path), tell each other their host names, and so learn their
    local rank and how many ranks share their host. A rank's device is
    cuda:{local_rank % device_count} (device None or 'cuda'), or the CPU.
    The backend is NCCL when on every host each rank has a card of its
    own, else gloo; it is printed once, by rank 0. A local run is a group of
    one. device=None means CUDA (raises without a GPU).
    """
    from pope_tpu_torch.utils.device import resolve_device

    env = env or resolve_env()
    dev = resolve_device(device)
    if env.source == "local" or not env.is_multiprocess:
        rank, world = 0, 1
        store = dist.HashStore()
    else:
        rank, world = int(env.process_id), int(env.num_processes)
        store = _store(env, rank, world)
    topo_store = dist.PrefixStore("pope_topology", store)
    topo_store.set(f"host/{rank}", socket.gethostname())
    hosts = [topo_store.get(f"host/{r}").decode() for r in range(world)]
    local = [r for r in range(world) if hosts[r] == hosts[rank]]
    local_rank, local_world = local.index(rank), len(local)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        own_card = local_world <= torch.cuda.device_count()
    else:
        own_card = False
    # every rank must pick the same backend: NCCL only if every host agrees
    topo_store.set(f"own_card/{rank}", "1" if own_card else "0")
    all_own = all(topo_store.get(f"own_card/{r}") == b"1" for r in range(world))
    backend = "nccl" if all_own else "gloo"
    if rank == 0:
        print(f"[pope_tpu_torch.parallel] {world} rank(s), {local_world} on this host, device "
              f"{dev.type}, backend {backend}", flush=True)
    if not dist.is_initialized():
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    return Topology(rank, world, local_rank, local_world, backend, dev)


def launch(
    fn: Callable,
    *,
    env: Optional[DistributedEnv] = None,
    tp: Optional[int] = None,
    argv: Sequence = (),
    log_level: int = logging.INFO,
    device=None,
):
    """Run `fn(mesh, *argv)` under the global (dp, tp) mesh.

    Every process calls launch() with the same code; the mesh spans all
    ranks; only rank 0 logs at `log_level` (the others at WARNING); a
    barrier runs before returning, so that no rank leaves while its peers
    still hold collectives in flight, and then the group is destroyed.
    """
    from pope_tpu_torch.parallel.mesh import make_mesh

    topo = initialize(env, device)
    root = logging.getLogger()
    if topo.rank != 0:
        root.setLevel(max(root.level, logging.WARNING))
    else:
        root.setLevel(min(root.level or log_level, log_level))
    try:
        mesh = make_mesh(tp=tp) if tp else make_mesh()
        return fn(mesh, *argv)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(index, fn, nprocs, coordinator, tp, argv, device, log_level):
    env = DistributedEnv(coordinator, nprocs, index, "explicit")
    launch(fn, env=env, tp=tp, argv=argv, device=device, log_level=log_level)


def spawn(fn: Callable, nprocs: int, *, argv: Sequence = (), tp: Optional[int] = None, device=None,
          coordinator: Optional[str] = None, log_level: int = logging.INFO,
          timeout: Optional[float] = None) -> None:
    """Start `nprocs` ranks on this host (start method spawn), each running
    launch(fn, ...). `fn` and `argv` must pickle (`fn` a module-level
    function). coordinator: "host:port" or "file:///path"; default a free
    localhost port. Returns when every rank has ended; raises if one
    failed (the others are then stopped), or TimeoutError, after stopping
    them all, when they outlast `timeout` seconds."""
    import time

    import torch.multiprocessing as mp

    coordinator = coordinator or f"localhost:{free_port()}"
    ctx = mp.start_processes(_spawned, args=(fn, nprocs, coordinator, tp, tuple(argv), device, log_level),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{nprocs} ranks still running after {timeout} s")
