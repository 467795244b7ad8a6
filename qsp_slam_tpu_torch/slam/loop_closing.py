"""Keyframe snapshots (counterpart of `qsp_slam_tpu/slam/loop_closing.py`,
the part every keyframe runs).  Each keyframe stores a fixed-size snapshot
of its features and a place signature, slot k for keyframe k; relocalization
and loop verification read them in later slices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..frontend.orb import DESC_BITS
from .place_recognition import PlaceDatabase, add_signature, bow_signature, empty_database


class LoopState(NamedTuple):
    db: PlaceDatabase
    kf_desc: torch.Tensor  # (Kmax, S, 256) int8 snapshot of each KF's features
    kf_pts_cam: torch.Tensor  # (Kmax, S, 3) camera-frame 3D points per feature
    kf_pts_ok: torch.Tensor  # (Kmax, S) bool
    kf_xy: torch.Tensor  # (Kmax, S, 2) pixel positions
    kf_feat_ok: torch.Tensor  # (Kmax, S) bool — feature validity
    kf_octave: torch.Tensor  # (Kmax, S) int8 pyramid level


def empty_loop_state(kmax: int = 64, snap: int = 384, device=None) -> LoopState:
    dev = resolve_device(device)

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return LoopState(
        db=empty_database(kmax, dev),
        kf_desc=z((kmax, snap, DESC_BITS), torch.int8),
        kf_pts_cam=z((kmax, snap, 3), torch.float32),
        kf_pts_ok=z((kmax, snap), torch.bool),
        kf_xy=z((kmax, snap, 2), torch.float32),
        kf_feat_ok=z((kmax, snap), torch.bool),
        kf_octave=z((kmax, snap), torch.int8),
    )


def snapshot_keyframe(
    ls: LoopState,
    desc_pm: torch.Tensor,  # (F, 256)
    feat_valid: torch.Tensor,  # (F,)
    pts_cam: torch.Tensor,  # (F, 3) camera-frame backprojections
    pts_ok: torch.Tensor,  # (F,)
    xy: torch.Tensor,  # (F, 2)
    octave: torch.Tensor | None = None,  # (F,)
) -> LoopState:
    """Store the first S features (strongest-first order) and the frame's
    signature in the next slot; at capacity the snapshot is dropped whole
    so slot k stays keyframe k."""
    S = ls.kf_desc.shape[1]
    Kmax = ls.kf_desc.shape[0]
    if octave is None:
        octave = torch.zeros(desc_pm.shape[0], dtype=torch.int8, device=desc_pm.device)
    fits = ls.db.count < Kmax
    kid = torch.clamp(ls.db.count, 0, Kmax - 1).long().reshape(1)

    def fit_rows(x, fill):
        """First S rows, padded with `fill` when the table is smaller."""
        if x.shape[0] >= S:
            return x[:S]
        pad = torch.full((S - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, pad])

    def put(store, rows):
        out = store.clone()
        out[kid] = torch.where(fits, rows.to(store.dtype), store[kid])
        return out

    return LoopState(
        db=add_signature(ls.db, bow_signature(desc_pm, feat_valid)),
        kf_desc=put(ls.kf_desc, fit_rows(desc_pm, 0)),
        kf_pts_cam=put(ls.kf_pts_cam, fit_rows(pts_cam, 0.0)),
        kf_pts_ok=put(ls.kf_pts_ok, fit_rows(pts_ok & feat_valid, False)),
        kf_xy=put(ls.kf_xy, fit_rows(xy, 0.0)),
        kf_feat_ok=put(ls.kf_feat_ok, fit_rows(feat_valid, False)),
        kf_octave=put(ls.kf_octave, fit_rows(octave.to(torch.int8), 0)),
    )


def grow_loop_state(ls: LoopState, kmax: int) -> LoopState:
    """Grow the snapshot store with the map (slot k <-> keyframe k)."""
    k0, snap = ls.kf_desc.shape[:2]
    if kmax <= k0:
        return ls
    tgt = empty_loop_state(kmax, snap, ls.kf_desc.device)
    rep = {}
    for name in LoopState._fields:
        if name == "db":
            continue
        out = getattr(tgt, name).clone()
        out[:k0] = getattr(ls, name)
        rep[name] = out
    signatures = tgt.db.signatures.clone()
    signatures[:k0] = ls.db.signatures
    rep["db"] = PlaceDatabase(signatures=signatures, df=ls.db.df, count=ls.db.count)
    return LoopState(**rep)
