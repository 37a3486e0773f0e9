"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program.  Module names are compared by
their top-level name whole: the port's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cylinder_pose_estimation_tpu"}
PROGRAM = "cylinder_pose_estimation_tpu_torch"


def imported_tops(path: Path) -> set:
    """Top-level names of every absolute import in a file, at any depth."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p.relative_to(REPO)): sorted(imported_tops(p) & FORBIDDEN) for p in files
           if imported_tops(p) & FORBIDDEN}
    assert not bad, bad


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert len(files) > 10
    bad = [str(p.relative_to(REPO)) for p in files if PROGRAM in imported_tops(p)]
    assert not bad, bad
    # The fit and the registration are the reference's own: not the copy of the port's detector either.
    for name in ("fit.py", "registration.py"):
        text = (BENCH / "reference" / name).read_text()
        assert imported_tops(BENCH / "reference" / name) <= {"__future__", "typing", "itertools", "numpy", "scipy",
                                                              "bench_h100"}, name
        assert "reference.port" not in text and "torch" not in text, name
    # The top-level comparison is whole-name: the program's name is not JAX's.
    assert PROGRAM.split(".")[0] not in FORBIDDEN


def test_import_scan_sees_nested_and_from_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("def f():\n    from jax import numpy\n    import cylinder_pose_estimation_tpu.ops\n"
                 "from cylinder_pose_estimation_tpu_torch import config\nfrom . import x\n")
    assert imported_tops(f) == {"jax", "cylinder_pose_estimation_tpu", "cylinder_pose_estimation_tpu_torch"}


def test_loaded_modules_of_the_harness_and_reference():
    """A fresh interpreter that imports the harness, every metric reader, the
    drivers with the program, and the reference, holds no forbidden module."""
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from bench_h100.common import harness, drivers, program
from bench_h100.reference import pipeline
program.port()
bench = harness.load_benchmark()
for entry in ("batch", "stream", "experiment"):
    drivers.load(entry)
for m in bench["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in tops
    assert not tops & FORBIDDEN, sorted(tops & FORBIDDEN)


def test_reference_alone_loads_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from bench_h100.reference import pipeline
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {PROGRAM})
