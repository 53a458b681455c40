"""The port's launch ladder (pope_tpu_torch/parallel/launch.py) against
pope_tpu's (pope_tpu/parallel/launch.py): every case of
tests/test_launch.py through both packages' resolve_env on the same
arguments and environment dicts, with equal fields or the same error; the
SLURM nodelist parser; and launch()'s contract in one local process (a
group of one on gloo, the mesh, rank 0's log level, the group gone after)."""

import dataclasses
import importlib
import logging

import pytest
import torch.distributed as dist

# the modules, not the packages' `launch` functions of the same name
jax_launch = importlib.import_module("pope_tpu.parallel.launch")
port_launch = importlib.import_module("pope_tpu_torch.parallel.launch")

SLURM = {"SLURM_JOB_ID": "90210", "SLURM_NTASKS": "4", "SLURM_PROCID": "1", "SLURM_JOB_NODELIST": "tpu-[001-004]"}
CASES = [
    # (explicit arguments, environment)
    (dict(coordinator="10.0.0.1:1234", num_processes=4, process_id=2),
     {"POPE_COORDINATOR_ADDRESS": "ignored:1", "SLURM_JOB_ID": "7"}),
    ({}, {"POPE_COORDINATOR_ADDRESS": "head:2222", "POPE_NUM_PROCESSES": "8", "POPE_PROCESS_ID": "3"}),
    ({}, {"POPE_COORDINATOR_ADDRESS": "head:2222"}),  # partial preset env
    ({}, SLURM),
    ({}, {**SLURM, "SLURM_PROCID": "3"}),
    ({}, {"SLURM_JOB_ID": "1", "SLURM_NTASKS": "1", "SLURM_PROCID": "0", "SLURM_JOB_NODELIST": "solo"}),
    (dict(num_processes=4, process_id=2), {}),
    (dict(coordinator="h:1", process_id=0), {}),
    (dict(process_id=2), {}),
    (dict(num_processes=4), {}),
    (dict(coordinator="h:1"), {}),
    (dict(coordinator="h:1", num_processes=4, process_id=2), {}),
    (dict(num_processes=1), {}),
    (dict(num_processes=1, process_id=0), {}),
    (dict(coordinator="h:1", num_processes=1, process_id=0), {}),
    ({}, {}),
]


def _resolve(module, kwargs, environ):
    try:
        env = module.resolve_env(environ=environ, **kwargs)
    except RuntimeError as e:
        return ("error", str(e))
    return (dataclasses.asdict(env), env.is_multiprocess)


@pytest.mark.parametrize("kwargs,environ", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_resolve_env_matches_pope_tpu(kwargs, environ):
    assert _resolve(port_launch, kwargs, environ) == _resolve(jax_launch, kwargs, environ)


def test_ladder_sources():
    """The ladder's order, on the port alone: explicit beats preset env,
    which beats SLURM; every SLURM rank derives one coordinator."""
    sources = [_resolve(port_launch, kw, env) for kw, env in CASES]
    assert sources[0][0]["source"] == "explicit"
    assert sources[1][0]["source"] == "preset-env"
    assert sources[2][0] == "error" and "partially set" in sources[2][1]
    assert sources[3][0]["source"] == "slurm" and sources[3][0]["coordinator_address"].startswith("tpu-001:")
    assert sources[4][0]["coordinator_address"] == sources[3][0]["coordinator_address"]
    assert sources[5][0]["source"] == "local"
    assert sources[-1][0]["source"] == "local"


@pytest.mark.parametrize("nodelist", ["tpuhost", "a,b,c", "tpu-[001-003]", "tpu-[001-002,007],login1", "x[9-11]"])
def test_parse_slurm_nodelist_matches_pope_tpu(nodelist):
    assert port_launch.parse_slurm_nodelist(nodelist) == jax_launch.parse_slurm_nodelist(nodelist)
    assert port_launch._slurm_port(90210) == jax_launch._slurm_port(90210)


def test_launch_runs_fn_under_the_mesh_and_cleans_up():
    """A local launch: a gloo group of one on the CPU, fn(mesh, *argv) with
    a (dp, tp) mesh, rank 0 at the given log level, no group afterwards."""
    seen = {}

    def entry(mesh, tag):
        seen["names"], seen["shape"] = mesh.mesh_dim_names, tuple(mesh.shape)
        seen["backend"], seen["tag"] = dist.get_backend(), tag
        seen["level"] = logging.getLogger().level
        return 42

    root = logging.getLogger()
    level = root.level
    try:
        out = port_launch.launch(entry, env=port_launch.DistributedEnv(None, None, None, "local"),
                                 argv=("hello",), log_level=logging.INFO, device="cpu")
    finally:
        root.setLevel(level)
    assert out == 42 and seen["tag"] == "hello"
    assert seen["names"] == ("dp", "tp") and seen["shape"] == (1, 1)
    assert seen["backend"] == "gloo"
    assert seen["level"] <= logging.INFO
    assert not dist.is_initialized()
