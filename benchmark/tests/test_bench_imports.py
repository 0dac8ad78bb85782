"""In a fresh process, the harness, every configuration, traffic,
generator and metric file and the reference load no module whose
top-level name is ``jax``, ``jaxlib``, ``cilium_tpu`` or ``oracle``
(compared whole), and the reference loads nothing of
``cilium_tpu_torch``."""

import json
import os
import subprocess
import sys

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "cilium_tpu", "oracle"}


def _loaded(code):
    prog = (f"import sys; sys.path.insert(0, {ROOT!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_the_harness_and_every_file_it_finds_load_no_reference():
    bench = os.path.join(ROOT, "benchmark")
    code = ["import benchmark.run, benchmark.harness.runner",
            "import benchmark.harness.trace, benchmark.harness.provenance",
            "from benchmark.harness import cell"]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        for w in json.load(f)["workloads"]:
            code.append(f"c = cell.load({w['name']!r})")
    for kind in ("configs", "generators", "metrics"):
        for f in sorted(os.listdir(os.path.join(bench, kind))):
            if f.endswith(".py") and f != "__init__.py":
                code.append(f"cell._module({kind!r}, {f[:-3]!r})")
    got = _loaded("\n".join(code))
    assert not got & FORBIDDEN, got & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    got = _loaded("import benchmark.reference.datapath, "
                  "benchmark.reference.policy")
    assert not got & (FORBIDDEN | {"cilium_tpu_torch", "torch"}), got
