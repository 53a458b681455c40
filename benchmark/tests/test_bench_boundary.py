"""What the harness and the reference load, compared by whole top-level
module names (pope_tpu_torch begins with pope_tpu), and the harness's
refusal to run without a card."""

import json
import os
import subprocess
import sys

from benchmark.cells import HERE

REPO = HERE.parent


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_nor_the_jax_package():
    mods = loaded("import benchmark.run, benchmark.harness, benchmark.spans\n"
                  "from benchmark.cells import Cell, find_spec, load_json\n"
                  "spec = load_json(find_spec())\n"
                  "for w in spec['workloads']:\n"
                  "    c = Cell(spec, w['name']); c.driver()\n"
                  "    [c.reader(m['name']) for m in c.metrics('per_layer')]\n"
                  "import pope_tpu_torch.pipeline.api, pope_tpu_torch.models.sam.amg\n")
    assert not mods & {"jax", "jaxlib", "flax", "pope_tpu"}
    assert "pope_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = loaded("import benchmark.reference.build, benchmark.reference.compare, benchmark.reference.control\n"
                  "import benchmark.reference.amg, benchmark.readings\n")
    assert not mods & {"jax", "jaxlib", "flax", "pope_tpu", "pope_tpu_torch"}


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "segment-vitl-b16", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "{" not in out.stdout and "images_per_s" not in out.stdout
