"""Kernel K2: pairwise Hamming distances on packed descriptors
(`csrc/hamming.cu`).

Replaces the Pallas TPU kernel `hamming_matrix_packed`
(`qsp_slam_tpu/ops/hamming.py`).  In the port the matcher's distances come
from it instead of the JAX package's ±1 int8 matmul
(`frontend/matcher.py:hamming_matrix`): once per frame in
`search_by_projection` at (map capacity, feature capacity) and once per
keyframe in `fuse_map_points` at (2048, 2048).  The card bounds it by
memory, by the (A, B) int32 output; the inner product runs on the int8
tensor cores (each bit a ±1 byte, distance = (256 - <a, b>) / 2, as the JAX
matcher computes it); see the CUDA source for the design.

Descriptors are (N, 8) int32 words holding the u32 bits: bit j of word w is
descriptor bit 32w + j.  `hamming_packed` takes the plain PyTorch version
only for tensors on the CPU; on CUDA it launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import build

_SIG = {
    "qsp_hamming_packed": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "qsp_hamming_packed_error": [ctypes.c_int],
}


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 word (its u32 bit pattern): the classic
    shift-and-mask reduction.  The masks clear the bits that an arithmetic
    right shift of a negative word fills in, and subtraction wraps, so the
    signed storage gives the unsigned count."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_packed_plain(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: XOR of the words and a
    popcount, in row chunks that bound the (rows, B, 8) temporaries (small
    chunks stay in the CPU's cache; the card takes large ones)."""
    A, B = bits_a.shape[0], bits_b.shape[0]
    out = torch.empty((A, B), dtype=torch.int32, device=bits_a.device)
    chunk = (1 << 18) if bits_a.device.type == "cpu" else (1 << 24)
    step = max(1, chunk // max(B * 8, 1))
    for s in range(0, A, step):
        x = torch.bitwise_xor(bits_a[s:s + step, None, :], bits_b[None, :, :])
        out[s:s + step] = _popcount32(x).sum(dim=-1, dtype=torch.int32)
    return out


def _check(x: torch.Tensor, name: str) -> None:
    if x.dim() != 2 or x.shape[1] != 8 or x.dtype != torch.int32:
        raise ValueError(f"{name} must be (N, 8) int32 words, got {x.dtype} {tuple(x.shape)}")


def hamming_packed(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(A, 8), (B, 8) int32 packed descriptors -> (A, B) int32 distances."""
    _check(bits_a, "bits_a")
    _check(bits_b, "bits_b")
    if bits_a.device != bits_b.device:
        raise ValueError("bits_a and bits_b are on different devices")
    if bits_a.device.type == "cpu":
        return hamming_packed_plain(bits_a, bits_b)
    if bits_a.device.type != "cuda" or not (bits_a.is_contiguous() and bits_b.is_contiguous()):
        raise ValueError("hamming_packed needs contiguous CUDA or CPU tensors")
    if bits_a.data_ptr() % 16 or bits_b.data_ptr() % 16:
        raise ValueError("hamming_packed's kernel loads 16-byte words: rows must start 16-byte aligned")
    lib = build.load("hamming", _SIG)
    A, B = bits_a.shape[0], bits_b.shape[0]
    out = torch.empty((A, B), dtype=torch.int32, device=bits_a.device)
    err = build.launch(lib.qsp_hamming_packed, bits_a.device, bits_a.data_ptr(),
                       bits_b.data_ptr(), out.data_ptr(), A, B)
    if err:
        raise RuntimeError(f"hamming_packed launch failed: {lib.qsp_hamming_packed_error(err).decode()}")
    hamming_packed.launches += 1
    hamming_packed.shapes[(A, B)] += 1
    return out


hamming_packed.launches = 0
hamming_packed.shapes = collections.Counter()  # launches per (A, B)
