"""Nothing the harness loads imports JAX or the JAX package: every module
under port_bench, and a whole tiny run of each cell on the CPU, in a
process where importing `jax`, `jaxlib`, `flax` or `qsp_slam_tpu` fails.
Top-level module names are compared whole (the part before the first
dot), since the port's own name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "qsp_slam_tpu"}

BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %r:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
sys.path.insert(0, %r)
""" % (FORBIDDEN, str(ROOT), str(ROOT / "port_bench" / "tests"))


def _modules():
    for path in sorted((ROOT / "port_bench").rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        if "tests" not in rel.parts:
            yield ".".join(rel.parts)


def test_top_level_names_are_compared_whole():
    assert "qsp_slam_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "qsp_slam_tpu.slam".split(".")[0] in FORBIDDEN


def test_no_source_of_the_harness_names_jax_or_the_jax_package():
    for path in (ROOT / "port_bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else [])
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "port_bench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert all(n.split(".")[0] in {"", "__future__", "numpy", "torch", "math"} for n in names), \
                    (path, names)


def test_every_module_and_a_whole_run_load_without_jax():
    code = BLOCKER + f"""
import importlib
for m in {list(_modules())!r}:
    importlib.import_module(m)
from port_bench_tiny import tiny_run
tiny_run("tum_rgbd_dsp.shapes")
bad = {{m.split(".")[0] for m in sys.modules}} & {FORBIDDEN!r}
print("LOADED", sorted(bad))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "OMP_NUM_THREADS": "4"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
