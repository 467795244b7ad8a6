#!/usr/bin/env python3
"""How far `__popc` bounds the XOR + popcount Hamming kernel, on the card.

    python3 tools/k2_popc_roof.py

Builds `tools/k2_popc_roof.cu` (the popcount kernel that kernel K2 used to
be) with `nvcc` and times, by CUDA events at (8192, 4000): that kernel
storing every distance; the same kernel with its store predicated off (all
loads and population counts, no output); and the port's K2 on the int8
tensor cores (`ops.hamming.hamming_packed`), all on the same inputs.  The
roof printed beside them is A * B * 8 population counts at 16 per clock
per SM (CUDA's throughput table for compute capability 9.0) on 132 SMs at
the card's maximum SM clock.  Prints the card's name and power limit and
one JSON line.  Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from qsp_slam_tpu_torch.ops import build  # noqa: E402
from qsp_slam_tpu_torch.ops.hamming import hamming_packed, hamming_packed_plain  # noqa: E402

A, B = 8192, 4000
REPS = 200
SMS = 132
POPC_PER_CLOCK_PER_SM = 16
INT_MIN = -(2**31)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_popc_roof: CUDA is not available", file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(f"card: {card}", flush=True)

    build.BUILD_DIR.mkdir(exist_ok=True)
    lib_path = build.BUILD_DIR / "libk2_popc_roof.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "tools" / "k2_popc_roof.cu")], check=True, timeout=300)
    lib = ctypes.CDLL(str(lib_path))
    lib.qsp_hamming_popc.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.qsp_hamming_popc.restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randint(-2**31, 2**31, (n, 8), generator=gen, device="cuda", dtype=torch.int64)
            .to(torch.int32) for n in (A, B))
    out = torch.zeros((A, B), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def popc(store_only_if: int):
        def run():
            err = lib.qsp_hamming_popc(a.data_ptr(), b.data_ptr(), out.data_ptr(), A, B,
                                       store_only_if, stream)
            if err:
                raise RuntimeError(f"hamming_popc launch failed: {err}")
        return run

    popc(INT_MIN)()
    torch.cuda.synchronize()
    ref = hamming_packed_plain(a, b)
    if not (torch.equal(out, ref) and torch.equal(hamming_packed(a, b), ref)):
        raise AssertionError("the popcount kernel or K2 differs from the plain version")

    max_mhz = float(smi("clocks.max.sm").split()[0])
    res = {
        "shape": [A, B],
        "popc_store_ms": cuda_ms(popc(INT_MIN), REPS),
        "popc_no_store_ms": cuda_ms(popc(-1), REPS),
        "k2_int8_mma_ms": cuda_ms(lambda: hamming_packed(a, b), REPS),
        "popc_roof_ms": A * B * 8 / (POPC_PER_CLOCK_PER_SM * SMS * max_mhz * 1e6) * 1e3,
        "max_sm_mhz": max_mhz,
        "sm_mhz_after": smi("clocks.sm"),
    }
    print(json.dumps(res))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
