"""Nothing the benchmark runs loads `jax` or the JAX package, and the
reference loads nothing of the program: names compared whole, by the
part before the first dot."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from perfbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "oarfish_tpu"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in spec.HERE.rglob("*.py"):
        assert not set(imported(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").rglob("*.py"):
        tops = set(imported(path))
        assert not tops & (FORBIDDEN | {"oarfish_tpu_torch", "perfbench"}), (
            path, tops)


SCRIPT = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from perfbench.tests.conftest import tiny
from perfbench import run, spec
from perfbench.reference import em, filters  # noqa: F401
for m in json.loads(Path({root!r}, "BENCHMARK.json").read_text())["per_layer"]:
    spec.reader(m["name"])
line = run.run_cell(tiny("sc"), 5, 0.5, True, device="cpu",
                    cache=Path({cache!r}))
loaded = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": line["correct"], "loaded": loaded}}))
"""


def test_a_run_loads_no_jax(tmp_path):
    code = SCRIPT.format(root=str(spec.ROOT), cache=str(tmp_path / "cache"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(spec.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "oarfish_tpu_torch" in got["loaded"]
    assert not set(got["loaded"]) & FORBIDDEN, got["loaded"]


def test_reference_alone_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.em, perfbench.reference.filters; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"oarfish_tpu_torch"}), loaded
