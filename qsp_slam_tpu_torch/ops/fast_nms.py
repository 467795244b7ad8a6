"""Kernel K1: fused FAST-9/16 score + 3x3 NMS (`csrc/fast_nms.cu`).

Replaces the Pallas TPU kernel `fast_score_nms_pallas`
(`qsp_slam_tpu/ops/fast_pallas.py`), whose function the JAX extractor
reaches through `fast_score_nms_auto`.  The card bounds it by memory
(8 B per pixel, read once and written once); see the CUDA source for the
design.  `extract_features` launches it twice per pyramid level (t = 20
and t = 7), 16 times per frame at 8 levels.

`fast_score_nms` takes the plain PyTorch version (`frontend.fast.fast_score`
+ `nms3x3`) only for a tensor on the CPU; on CUDA it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..frontend.fast import fast_score, nms3x3
from . import build

_SIG = {
    "qsp_fast_score_nms": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "qsp_fast_score_nms_error": [ctypes.c_int],
}


def fast_score_nms_plain(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the oracle and CPU path)."""
    return nms3x3(fast_score(img, threshold))


def fast_score_nms(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """NMS'd FAST score map of an (H, W) f32 image (0 where suppressed)."""
    if img.dim() != 2 or img.dtype != torch.float32:
        raise ValueError(f"fast_score_nms takes an (H, W) float32 image, got {img.dtype} {tuple(img.shape)}")
    if img.device.type == "cpu":
        return fast_score_nms_plain(img, threshold)
    if img.device.type != "cuda" or not img.is_contiguous():
        raise ValueError("fast_score_nms needs a contiguous CUDA or CPU tensor")
    lib = build.load("fast_nms", _SIG)
    H, W = img.shape
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.qsp_fast_score_nms(img.data_ptr(), out.data_ptr(), H, W,
                                     float(threshold), stream)
    if err:
        raise RuntimeError(f"fast_score_nms launch failed: {lib.qsp_fast_score_nms_error(err).decode()}")
    fast_score_nms.launches += 1
    return out


fast_score_nms.launches = 0
