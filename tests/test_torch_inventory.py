"""The port covers the JAX package: every module of `qsp_slam_tpu/` has a
counterpart file under `qsp_slam_tpu_torch/` with the same relative path,
and every public top-level function and class (and every public method of
a class both packages define) has a counterpart of the same name there,
read from the sources with `ast`.  The exceptions are the table below,
each with the counterpart it maps to, which must exist, and its reason.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = REPO / "qsp_slam_tpu", REPO / "qsp_slam_tpu_torch"

# JAX module -> port module, where the port names it after what it holds.
MODULES = {
    "ops/fast_pallas.py": ("ops/fast_nms.py", "K1's Pallas kernel is the CUDA kernel csrc/fast_nms.cu behind "
                                              "ops/fast_nms.py"),
}

# "module:name" of the JAX package -> ("module:name" in the port, reason).
NAMES = {
    "ops/fast_pallas.py:fast_score_nms_pallas": (
        "ops/fast_nms.py:fast_score_nms_pyramid", "K1: one CUDA launch per frame over every level and threshold"),
    "ops/fast_pallas.py:fast_score_nms_auto": (
        "ops/fast_nms.py:fast_score_nms", "the device dispatch: a CUDA tensor launches K1, a CPU tensor runs "
                                          "the plain version"),
    "ops/hamming.py:hamming_matrix_packed": ("ops/hamming.py:hamming_packed", "K2, the CUDA kernel csrc/hamming.cu"),
    "ops/hamming.py:hamming_matrix_auto": (
        "ops/hamming.py:hamming_packed", "the device dispatch: a CUDA tensor launches K2, a CPU tensor runs the "
                                         "plain version (no plain path on a card)"),
    "core/camera.py:Intrinsics.K": (
        "core/camera.py:intrinsic_matrix", "the port's Intrinsics is a NamedTuple of floats; K is built on a device"),
    "utils/tracing.py:xla_trace": (
        "utils/tracing.py:device_trace", "a torch.profiler trace in place of a jax.profiler one"),
    "data/make_tum.py:rotmat_to_quat": ("core/lie.py:rotmat_to_quat", "one quaternion conversion for the package"),
    "data/native_loader.py:native_available": (
        "data/native_loader.py:library", "the port builds its decoder at first use and raises when it cannot; "
                                         "there is no availability probe and no fallback"),
    "parallel/multihost.py:make_global": (
        "parallel/mesh.py:broadcast", "ranks are processes holding whole tensors: rank 0's inputs are broadcast, "
                                      "no global jax.Array is assembled"),
}


def public(tree: ast.Module) -> tuple[set, dict]:
    """Top-level public functions and classes, and each class's public methods."""
    names, methods = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            methods[node.name] = {m.name for m in node.body
                                  if isinstance(m, ast.FunctionDef) and not m.name.startswith("_")}
    return names, methods


def parse(root: Path, rel: str):
    return public(ast.parse((root / rel).read_text()))


def jax_modules() -> list[str]:
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def port_module(rel: str) -> str:
    return MODULES[rel][0] if rel in MODULES else rel


@pytest.mark.parametrize("rel", jax_modules())
def test_module_has_a_counterpart(rel):
    assert (PORT / port_module(rel)).is_file(), f"qsp_slam_tpu_torch/{port_module(rel)} is missing"
    names, methods = parse(JAX, rel)
    port_names, port_methods = parse(PORT, port_module(rel))
    missing = []
    for name in sorted(names):
        if name not in port_names and f"{rel}:{name}" not in NAMES:
            missing.append(name)
    for cls, ms in methods.items():
        for m in sorted(ms - port_methods.get(cls, set())):
            if cls in port_names and f"{rel}:{cls}.{m}" not in NAMES:
                missing.append(f"{cls}.{m}")
    assert missing == [], f"{rel}: no counterpart in the port for {missing}"


def test_every_exception_maps_to_something_that_exists():
    assert set(MODULES) <= set(jax_modules())
    for key, (target, reason) in NAMES.items():
        rel, name = key.split(":")
        names, methods = parse(JAX, rel)
        cls, _, meth = name.partition(".")
        assert (meth in methods.get(cls, ())) if meth else (name in names), f"{key} is not in the JAX package"
        t_rel, t_name = target.split(":")
        assert t_name in parse(PORT, t_rel)[0], f"{target} is not in the port"
        assert reason
    # Every exception is needed: the port does not also carry the JAX name.
    for key in NAMES:
        rel, name = key.split(":")
        cls, _, meth = name.partition(".")
        port_names, port_methods = parse(PORT, port_module(rel))
        assert (meth not in port_methods.get(cls, ())) if meth else (name not in port_names), key
