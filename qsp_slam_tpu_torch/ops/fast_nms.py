"""Kernel K1: fused FAST-9/16 score + 3x3 NMS (`csrc/fast_nms.cu`).

Replaces the Pallas TPU kernel `fast_score_nms_pallas`
(`qsp_slam_tpu/ops/fast_pallas.py`), whose function the JAX extractor
reaches through `fast_score_nms_auto`.  One launch computes every level of
an image pyramid at one or two thresholds; `extract_features` makes one
such launch per frame (8 levels x t = 20 and 7).  See the CUDA source for
the design and its bound.

`fast_score_nms_pyramid` and the single-image `fast_score_nms` take the
plain PyTorch version (`frontend.fast.fast_score` + `nms3x3`) only for
tensors on the CPU; on CUDA they launch the kernel or raise.  Both count
their launches in `fast_score_nms_pyramid.launches`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..frontend.fast import fast_score, nms3x3
from . import build

MAX_LEVELS = 16
_TX, _TY = 32, 16  # the kernel's tile (kTx, kTy in csrc/fast_nms.cu)


class _Level(ctypes.Structure):
    _fields_ = [("img", ctypes.c_void_p), ("out", ctypes.c_void_p * 2),
                ("H", ctypes.c_int), ("W", ctypes.c_int), ("first_tile", ctypes.c_int)]


class _Pyramid(ctypes.Structure):
    _fields_ = [("lv", _Level * MAX_LEVELS), ("t", ctypes.c_float * 2),
                ("n_levels", ctypes.c_int), ("n_thresholds", ctypes.c_int),
                ("n_tiles", ctypes.c_int)]


_SIG = {
    "qsp_fast_score_nms_pyramid": [_Pyramid, ctypes.c_void_p],
    "qsp_fast_score_nms_error": [ctypes.c_int],
}


def fast_score_nms_plain(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the oracle and CPU path)."""
    return nms3x3(fast_score(img, threshold))


def fast_score_nms_pyramid_plain(levels, thresholds) -> list[tuple[torch.Tensor, ...]]:
    """`fast_score_nms_pyramid` in plain PyTorch: each level at each threshold."""
    return [tuple(fast_score_nms_plain(im, t) for t in thresholds) for im in levels]


_WORDS = ctypes.sizeof(_Level) // 8  # a level's size in 8-byte words
_IMG_WORD = _Level.img.offset // 8
_OUT_WORD = _Level.out.offset // 8


class _Plan(NamedTuple):
    """What a launch over one list of level shapes needs besides pointers."""

    template: _Pyramid  # shapes, first tiles, thresholds; pointers unset
    img_words: np.ndarray  # 8-byte word of each level's image pointer
    out_words: np.ndarray  # ... and of each output pointer
    out_bytes: np.ndarray  # each map's byte offset in the flat buffer
    views: tuple  # per level, per threshold: (shape, stride, offset)
    numel: int


@lru_cache(maxsize=64)
def _plan(shapes: tuple[tuple[int, int], ...], thresholds: tuple[float, ...]) -> _Plan:
    """Tiles are numbered level by level; maps lie in the flat buffer level
    by level, threshold by threshold."""
    n = len(thresholds)
    p = _Pyramid(n_levels=len(shapes), n_thresholds=n)
    p.t[:n] = thresholds
    views, off = [], 0
    for i, (H, W) in enumerate(shapes):
        p.lv[i].H, p.lv[i].W, p.lv[i].first_tile = H, W, p.n_tiles
        p.n_tiles += -(-H // _TY) * -(-W // _TX)
        views.append(tuple(((H, W), (W, 1), off + j * H * W) for j in range(n)))
        off += n * H * W
    lv = np.arange(len(shapes))[:, None] * _WORDS
    return _Plan(
        template=p,
        img_words=lv[:, 0] + _IMG_WORD,
        out_words=(lv + _OUT_WORD + np.arange(n)).ravel(),
        out_bytes=np.array([4 * v[2] for lv_views in views for v in lv_views], dtype=np.uint64),
        views=tuple(views),
        numel=off,
    )


def _launch_struct(plan: _Plan, img_ptrs: list[int], buf_ptr: int) -> _Pyramid:
    """The plan's template with each level's image pointer and each map's
    pointer into the flat output buffer filled in."""
    p = _Pyramid.from_buffer_copy(plan.template)
    words = np.frombuffer(p, dtype=np.uint64)
    words[plan.img_words] = img_ptrs
    words[plan.out_words] = plan.out_bytes + np.uint64(buf_ptr)
    return p


def fast_score_nms_pyramid(levels, thresholds) -> list[tuple[torch.Tensor, ...]]:
    """NMS'd FAST score maps of a list of (H, W) f32 images at one or two
    thresholds: result[l][j] is level l at thresholds[j] (0 where
    suppressed).  One kernel launch for the whole list on CUDA; the maps
    are views of one flat buffer."""
    levels, thresholds = list(levels), tuple(float(t) for t in thresholds)
    if not 1 <= len(levels) <= MAX_LEVELS or not 1 <= len(thresholds) <= 2:
        raise ValueError(f"fast_score_nms_pyramid takes 1-{MAX_LEVELS} levels and 1-2 thresholds, "
                         f"got {len(levels)} and {len(thresholds)}")
    dev = levels[0].device
    for im in levels:
        if im.dim() != 2 or im.dtype != torch.float32 or im.device != dev or not im.is_contiguous():
            raise ValueError("fast_score_nms_pyramid takes contiguous (H, W) float32 images on one "
                             f"device, got {im.dtype} {tuple(im.shape)} on {im.device}")
    if dev.type == "cpu":
        return fast_score_nms_pyramid_plain(levels, thresholds)
    if dev.type != "cuda":
        raise ValueError(f"fast_score_nms_pyramid runs on CUDA or the CPU, not {dev}")
    lib = build.load("fast_nms", _SIG)
    plan = _plan(tuple((im.shape[0], im.shape[1]) for im in levels), thresholds)
    buf = torch.empty(plan.numel, dtype=torch.float32, device=dev)
    p = _launch_struct(plan, [im.data_ptr() for im in levels], buf.data_ptr())
    err = build.launch(lib.qsp_fast_score_nms_pyramid, dev, p)
    if err:
        raise RuntimeError(f"fast_score_nms_pyramid launch failed: {lib.qsp_fast_score_nms_error(err).decode()}")
    fast_score_nms_pyramid.launches += 1
    return [tuple(buf.as_strided(*v) for v in lv_views) for lv_views in plan.views]


fast_score_nms_pyramid.launches = 0


def fast_score_nms(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """NMS'd FAST score map of one (H, W) f32 image (0 where suppressed):
    one level at one threshold of `fast_score_nms_pyramid`."""
    return fast_score_nms_pyramid([img], (threshold,))[0][0]
