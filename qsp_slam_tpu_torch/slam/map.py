"""SoA map state: keyframes, points and observations in capacity-padded
arrays with validity masks (counterpart of `qsp_slam_tpu/slam/map.py`,
same field names, dtypes and capacities).

Functions return a new MapState and leave their argument untouched, as the
JAX package's pure functions do; the counters are 0-d int32 tensors on the
map's device, so no update needs a host sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..frontend.orb import DESC_BITS


class MapState(NamedTuple):
    # keyframes
    kf_Tcw: torch.Tensor  # (Kmax, 4, 4) f32
    kf_valid: torch.Tensor  # (Kmax,) bool
    num_kfs: torch.Tensor  # () int32
    # points
    pt_xyz: torch.Tensor  # (Nmax, 3) f32
    pt_desc: torch.Tensor  # (Nmax, 256) int8 — matching form (±1, sign of acc)
    pt_desc_acc: torch.Tensor  # (Nmax, 256) int8 — majority-vote accumulator
    pt_octave: torch.Tensor  # (Nmax,) int32
    pt_normal: torch.Tensor  # (Nmax, 3) f32 mean viewing direction
    pt_obs_count: torch.Tensor  # (Nmax,) int32
    pt_valid: torch.Tensor  # (Nmax,) bool
    num_pts: torch.Tensor  # () int32
    # observations (BA edge store)
    ob_kf: torch.Tensor  # (Emax,) int32
    ob_pt: torch.Tensor  # (Emax,) int32
    ob_uv: torch.Tensor  # (Emax, 2) f32
    ob_ur: torch.Tensor  # (Emax,) f32  (-1 for mono)
    ob_octave: torch.Tensor  # (Emax,) int32
    ob_valid: torch.Tensor  # (Emax,) bool
    num_obs: torch.Tensor  # () int32

    @property
    def capacity(self) -> tuple[int, int, int]:
        return self.kf_Tcw.shape[0], self.pt_xyz.shape[0], self.ob_kf.shape[0]

    @property
    def device(self) -> torch.device:
        return self.kf_Tcw.device


def empty_map(kmax: int = 64, nmax: int = 8192, emax: int = 65536, device=None) -> MapState:
    dev = resolve_device(device)
    i32, f32 = torch.int32, torch.float32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return MapState(
        kf_Tcw=torch.eye(4, dtype=f32, device=dev).repeat(kmax, 1, 1),
        kf_valid=z(kmax, torch.bool),
        num_kfs=z((), i32),
        pt_xyz=z((nmax, 3), f32),
        pt_desc=z((nmax, DESC_BITS), torch.int8),
        pt_desc_acc=z((nmax, DESC_BITS), torch.int8),
        pt_octave=z(nmax, i32),
        pt_normal=z((nmax, 3), f32),
        pt_obs_count=z(nmax, i32),
        pt_valid=z(nmax, torch.bool),
        num_pts=z((), i32),
        ob_kf=z(emax, i32),
        ob_pt=z(emax, i32),
        ob_uv=z((emax, 2), f32),
        ob_ur=torch.full((emax,), -1.0, dtype=f32, device=dev),
        ob_octave=z(emax, i32),
        ob_valid=z(emax, torch.bool),
        num_obs=z((), i32),
    )


def set_rows(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Copy of `dst` with dst[idx[i]] = src[i] where ok[i]; other rows are
    dropped (the reference's `.at[].set(mode="drop")` with out-of-range
    parking).  Rows with `ok` must have distinct indices."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    ext[torch.where(ok, idx.long(), n)] = src.to(dst.dtype)
    return ext[:n]


def scatter_set_last(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Copy of `dst` with dst[idx[i]] = src[i], where among duplicate
    indices the last row in index order wins.

    That is what the JAX package's `.at[idx].set(src)` does on XLA:CPU,
    and two of its keyframe-insertion writes depend on it; CUDA's
    `index_put_` would pick a duplicate at random."""
    n = dst.shape[0]
    rows = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, idx.long(), rows, "amax")
    picked = src.to(dst.dtype)[torch.clamp(last, min=0)]
    hit = (last >= 0).reshape((n,) + (1,) * (dst.dim() - 1))
    return torch.where(hit, picked, dst)


def add_keyframe(m: MapState, Tcw: torch.Tensor) -> tuple[MapState, torch.Tensor]:
    """Append a keyframe -> (map, kf_id); kf_id is -1 and the write is
    dropped when the store is full."""
    Kmax = m.kf_Tcw.shape[0]
    fits = m.num_kfs < Kmax
    kid = torch.clamp(m.num_kfs, 0, Kmax - 1).long().reshape(1)
    kf_Tcw = m.kf_Tcw.clone()
    kf_Tcw[kid] = torch.where(fits, Tcw, m.kf_Tcw[kid])
    kf_valid = m.kf_valid.clone()
    kf_valid[kid] = m.kf_valid[kid] | fits
    return (
        m._replace(kf_Tcw=kf_Tcw, kf_valid=kf_valid, num_kfs=m.num_kfs + fits.to(torch.int32)),
        torch.where(fits, m.num_kfs, -1),
    )


def add_points(
    m: MapState,
    xyz: torch.Tensor,  # (P, 3)
    desc: torch.Tensor,  # (P, 256) int8
    octave: torch.Tensor,  # (P,)
    normal: torch.Tensor,  # (P, 3)
    valid: torch.Tensor,  # (P,) bool
) -> tuple[MapState, torch.Tensor]:
    """Append a batch of points; valid rows fill the first free slots in
    row order.  Returns (map, ids (P,)) with -1 for invalid or overflow rows."""
    Nmax = m.pt_xyz.shape[0]
    order = torch.argsort((~valid).to(torch.uint8), stable=True)  # valid rows first
    xyz, desc = xyz[order], desc[order]
    octave, normal, valid_s = octave[order], normal[order], valid[order]
    offsets = torch.cumsum(valid_s.to(torch.int32), 0) - 1
    valid_s = valid_s & (m.num_pts + offsets < Nmax)
    ids = m.num_pts + offsets
    new = m._replace(
        pt_xyz=set_rows(m.pt_xyz, ids, xyz, valid_s),
        pt_desc=set_rows(m.pt_desc, ids, desc, valid_s),
        pt_desc_acc=set_rows(m.pt_desc_acc, ids, desc, valid_s),
        pt_octave=set_rows(m.pt_octave, ids, octave, valid_s),
        pt_normal=set_rows(m.pt_normal, ids, normal, valid_s),
        pt_valid=set_rows(m.pt_valid, ids, torch.ones_like(valid_s), valid_s),
        num_pts=m.num_pts + torch.sum(valid_s.to(torch.int32)).to(torch.int32),
    )
    inv = torch.argsort(order)
    ids_out = torch.where(valid_s, ids, -1)[inv]
    return new, ids_out.to(torch.int32)


def add_observations(
    m: MapState,
    kf_id: torch.Tensor,
    pt_ids: torch.Tensor,  # (P,) int32, -1 = skip
    uv: torch.Tensor,  # (P, 2)
    u_right: torch.Tensor,  # (P,)
    octave: torch.Tensor,  # (P,)
) -> MapState:
    """Append observation edges for one keyframe (valid rows compacted);
    rows past capacity and whole batches with kf_id < 0 are dropped."""
    Emax = m.ob_kf.shape[0]
    valid = (pt_ids >= 0) & (kf_id >= 0)
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    pt_s, uv_s = pt_ids[order], uv[order]
    ur_s, oct_s, val_s = u_right[order], octave[order], valid[order]
    offsets = torch.cumsum(val_s.to(torch.int32), 0) - 1
    val_s = val_s & (m.num_obs + offsets < Emax)
    slots = m.num_obs + offsets
    pt_obs_count = m.pt_obs_count.clone().index_add_(
        0, torch.where(val_s, pt_s, 0).long(), val_s.to(torch.int32)
    )
    return m._replace(
        ob_kf=set_rows(m.ob_kf, slots, kf_id.expand_as(pt_s), val_s),
        ob_pt=set_rows(m.ob_pt, slots, pt_s, val_s),
        ob_uv=set_rows(m.ob_uv, slots, uv_s, val_s),
        ob_ur=set_rows(m.ob_ur, slots, ur_s, val_s),
        ob_octave=set_rows(m.ob_octave, slots, oct_s, val_s),
        ob_valid=set_rows(m.ob_valid, slots, torch.ones_like(val_s), val_s),
        num_obs=m.num_obs + torch.sum(val_s.to(torch.int32)).to(torch.int32),
        pt_obs_count=pt_obs_count,
    )


def _segment_count(mask: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.int32, device=mask.device)
    return out.index_add_(0, seg.long(), mask.to(torch.int32))


def compact_edges(m: MapState) -> MapState:
    """Pack live observation edges to the front (edges of dead points or
    keyframes are dropped); `num_obs` becomes the live count."""
    alive = m.ob_valid & m.pt_valid[m.ob_pt.long()] & m.kf_valid[m.ob_kf.long()]
    order = torch.argsort((~alive).to(torch.uint8), stable=True)
    alive_s = alive[order]
    return m._replace(
        ob_kf=torch.where(alive_s, m.ob_kf[order], 0),
        ob_pt=torch.where(alive_s, m.ob_pt[order], 0),
        ob_uv=torch.where(alive_s[:, None], m.ob_uv[order], 0.0),
        ob_ur=torch.where(alive_s, m.ob_ur[order], -1.0),
        ob_octave=torch.where(alive_s, m.ob_octave[order], 0),
        ob_valid=alive_s,
        num_obs=torch.sum(alive.to(torch.int32)).to(torch.int32),
        pt_obs_count=_segment_count(alive, m.ob_pt, m.pt_xyz.shape[0]),
    )


def compact_points(m: MapState) -> MapState:
    """Pack live points to the front and remap the edge store's point ids.
    Only safe between frames (a frame's match results hold point ids)."""
    order = torch.argsort((~m.pt_valid).to(torch.uint8), stable=True)
    inv = torch.argsort(order)  # old id -> new id
    valid_s = m.pt_valid[order]
    edge_alive = m.ob_valid & m.pt_valid[m.ob_pt.long()]
    return m._replace(
        pt_xyz=torch.where(valid_s[:, None], m.pt_xyz[order], 0.0),
        pt_desc=torch.where(valid_s[:, None], m.pt_desc[order], 0),
        pt_desc_acc=torch.where(valid_s[:, None], m.pt_desc_acc[order], 0),
        pt_octave=torch.where(valid_s, m.pt_octave[order], 0),
        pt_normal=torch.where(valid_s[:, None], m.pt_normal[order], 0.0),
        pt_obs_count=torch.where(valid_s, m.pt_obs_count[order], 0),
        pt_valid=valid_s,
        num_pts=torch.sum(m.pt_valid.to(torch.int32)).to(torch.int32),
        ob_pt=torch.where(edge_alive, inv[m.ob_pt.long()].to(torch.int32), 0),
        ob_valid=edge_alive,
    )


def grow_map(m: MapState, kmax: int | None = None, nmax: int | None = None,
             emax: int | None = None) -> MapState:
    """Pad every store to a larger capacity; all ids are preserved."""
    k0, n0, e0 = m.capacity
    tgt = empty_map(max(kmax or k0, k0), max(nmax or n0, n0), max(emax or e0, e0), m.device)
    rep = {}
    for name in MapState._fields:
        src, dst = getattr(m, name), getattr(tgt, name)
        if src.dim() == 0:
            rep[name] = src
        else:
            dst = dst.clone()
            dst[tuple(slice(0, s) for s in src.shape)] = src
            rep[name] = dst
    return MapState(**rep)
