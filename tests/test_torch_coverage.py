"""The port does all that pope_tpu does: by AST (nothing is imported), every
pope_tpu module has its counterpart under pope_tpu_torch/, with every public
top-level name (functions, classes, constants) and every name a package's
__init__ exports, and the port's CLI has every pope_tpu command with every
one of its options. The only exceptions are NOT_PORTED, each with its
reason."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "pope_tpu", ROOT / "pope_tpu_torch"

# "module" or "module::name" (module paths relative to the package) -> why
NOT_PORTED = {
    "ops/linalg.py": "fixed-sweep Jacobi eigh / svd3, a TPU-only branch of the solver; the port uses "
                     "torch.linalg, as pope_tpu's non-TPU branch uses jnp.linalg",
    "utils/precision.py": "the f32_matmul decorator stops the TPU from running f32 products at bf16 "
                          "precision; the port's entry points turn TF32 off (utils/device.py::resolve_device)",
    "parallel/compat.py": "a shim over jax.shard_map's API change between JAX versions; torch.distributed "
                          "needs none",
    "pipeline/runner.py::pair_key": "a per-pair jax.random key; the port draws per-pair solver noise with "
                                    "runner.pair_noise (seeded by the crc32 of the pair name)",
    "pipeline/runner.py::pair_keys_np": "the host twin of pair_key, for the same reason",
    "models/regressor/train.py::TrainState": "flax's train state; the port's is RegressorTrainState (the model, "
                                             "its torch optimizer and scheduler)",
    "models/regressor/__init__.py::TrainState": "re-export of the flax train state above",
    "utils/lpips.py::lpips_distance_jit": "a jax.jit wrapper of lpips_distance; the port calls lpips_distance",
}


def _public(path: Path) -> set:
    """Public top-level names of a module; for a package __init__, also the
    names it imports (its exports)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def test_not_ported_entries_exist_and_have_reasons():
    for key, reason in NOT_PORTED.items():
        module, _, name = key.partition("::")
        assert (JAX / module).exists(), key
        assert not name or name in _public(JAX / module), key
        assert len(reason) > 20, key


@pytest.mark.parametrize("module", MODULES)
def test_module_has_its_counterpart(module):
    if module in NOT_PORTED:
        return
    assert (PORT / module).exists(), f"pope_tpu_torch/{module} is missing"
    missing = sorted(n for n in _public(JAX / module) - _public(PORT / module)
                     if f"{module}::{n}" not in NOT_PORTED)
    assert not missing, f"pope_tpu_torch/{module} lacks {missing}"


def _cli_surface(path: Path) -> dict:
    """{command: {options}} of a cli.py: each `sub.add_parser(name)` bound
    to a variable, that variable's add_argument flags, and the flags that a
    helper function taking the parser adds (`_add_model_args(p)`)."""
    tree = ast.parse(path.read_text())
    helpers = {}
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef) and n.args.args):
        param = fn.args.args[0].arg
        flags = {a.value for call in ast.walk(fn) if isinstance(call, ast.Call)
                 and isinstance(call.func, ast.Attribute) and call.func.attr == "add_argument"
                 and isinstance(call.func.value, ast.Name) and call.func.value.id == param
                 for a in call.args if isinstance(a, ast.Constant)}
        if flags:
            helpers[fn.name] = flags
    commands, var_cmd = {}, {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute) and node.value.func.attr == "add_parser"):
            name = node.value.args[0].value
            var_cmd[node.targets[0].id] = name
            commands[name] = set()
    for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "add_argument" and isinstance(f.value, ast.Name) \
                and f.value.id in var_cmd:
            commands[var_cmd[f.value.id]].update(a.value for a in call.args if isinstance(a, ast.Constant))
        elif isinstance(f, ast.Name) and f.id in helpers and call.args and isinstance(call.args[0], ast.Name) \
                and call.args[0].id in var_cmd:
            commands[var_cmd[call.args[0].id]].update(helpers[f.id])
    return commands


def test_cli_has_every_command_and_option():
    jax_cli, port_cli = _cli_surface(JAX / "cli.py"), _cli_surface(PORT / "cli.py")
    assert len(jax_cli) >= 15 and "parse-lm" in jax_cli
    missing = {cmd: sorted(opts - port_cli.get(cmd, set())) for cmd, opts in jax_cli.items()
               if cmd not in port_cli or opts - port_cli[cmd]}
    assert not missing, f"the port's CLI lacks {missing}"
