"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and compiles with `nvcc` for
`sm_90a` into `_build/lib<name>-<hash>.so` inside the package (the hash of
the source names the library, so an edited source never loads a stale
build).  Libraries load with `ctypes`.  There is no fallback: a missing
`nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str], verbose: bool = False) -> dict[str, str]:
    """Compile the named sources that are not built yet, one `nvcc` per
    source, all started together.  Returns each name's compiler output
    (register and shared-memory use when `verbose`)."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: {logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signature: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>; `signature` maps each exported
    function to its ctypes argument types (c_void_p for pointers and the
    stream).  A launch function returns the launch's cudaError_t; the
    `*_error` function of each library turns that code into its message."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signature.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = (
                ctypes.c_char_p if fn.endswith("_error") else ctypes.c_int
            )
        _loaded[name] = lib
    return lib


def launch(fn, device: torch.device, *args) -> int:
    """Call a launch function with `args` and the current stream of
    `device`, making `device` current only when it is not (entering the
    device context costs more host time than most of these launches)."""
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream().cuda_stream)
    return fn(*args, torch.cuda.current_stream().cuda_stream)
