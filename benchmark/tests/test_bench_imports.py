"""Nothing the benchmark runs imports jax, jaxlib, flax or the JAX package
(top-level names compared whole; slamtpu_torch is the port), and nothing
under benchmark/ reads bench.py or chip_smoke.py."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import settings
from benchmark.tests import small

FORBIDDEN = {"jax", "jaxlib", "flax", "slamtpu", "bench", "chip_smoke"}

DRY_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.tests import small
for cell in {cells!r}:
    spec, config, traffic, limits = small.files(cell)
    harness.run(cell, 7, 0.5, True, time.perf_counter(), device="cpu", spec=spec, config=config, traffic=traffic,
                limits=limits)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_source_imports_jax_or_the_jax_package():
    for path in settings.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)
        if path != Path(__file__).resolve():
            text = path.read_text()
            assert "bench.py" not in text and "chip_smoke" not in text, path


def test_a_dry_run_loads_no_jax_module():
    cells = [w["name"] for w in settings.spec()["workloads"]]
    code = DRY_RUN.format(root=str(settings.ROOT), cells=cells)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=str(settings.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "slamtpu_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "slamtpu"}, top & {"jax", "jaxlib", "flax", "slamtpu"}
