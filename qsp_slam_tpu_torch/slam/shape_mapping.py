"""Per-object DeepSDF reconstruction in the mapping loop (counterpart of
`qsp_slam_tpu/slam/shape_mapping.py`).

At a keyframe, each due object (live, in front of the camera, seen at
least `min_obs` times and at an even count) samples surface points and
rays in its projected box from the keyframe's depth and starts from the
ellipsoid's normalized frame; then `reconstruct_due_objects` runs the
joint pose + code LM over those objects x their flip hypotheses.  The
reference computes every slot and keeps the due ones; here the host reads
`due` once and only the due slots are computed, in chunks of hypotheses
sized to the device's memory.  The pixel draw is split from the rest
(`draw`, unit uniforms (O, S, 2)), so tests can feed the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie, quadric
from ..core.camera import Intrinsics, backproject, intrinsic_matrix, pixel_rays
from ..models.deepsdf import DeepSDFConfig
from ..models.shape_opt import ShapeOptConfig, ShapeOptResult, flip_hypotheses, pick_flips, reconstruct_object
from ..perception.ellipsoid_fit import Draw, _scaled, bbox_sample
from .map import scatter_set_last
from ..utils.tracing import HOST_READS, count, fetch
from .objects import ObjectTable

SCALE_MARGIN = 1.4  # ellipsoid max half-axis -> unit-sphere scale margin
RENDER_SAMPLES = 32  # depth samples per ray of the render term
CPU_BUDGET_BYTES = 4 << 30  # the LM's tangent working set per chunk on the CPU
WORKING_SET = 3.2  # tangent-batch layers alive at once in an LM trip on the CPU (measured 3.14)
REVERSE_WORKING_SET = 1.2  # the card's trip over its saved activations and J (H100: 1.09-1.14)


class ShapeInputs(NamedTuple):
    T_oc_init: torch.Tensor  # (O, 4, 4)
    pts_cam: torch.Tensor  # (O, P, 3)
    pts_ok: torch.Tensor  # (O, P) surface (foreground) points for the SDF term
    rays: torch.Tensor  # (O, P, 3)
    depth_obs: torch.Tensor  # (O, P)
    rays_ok: torch.Tensor  # (O, P) rays for the render (free-space) term
    due: torch.Tensor  # (O,)


def gather_shape_inputs(
    table: ObjectTable,
    Tcw: torch.Tensor,
    depth: torch.Tensor,  # (H, W)
    ground_cam: torch.Tensor,  # (4,)
    intr: Intrinsics,
    gen: torch.Generator | None,
    det_masks: torch.Tensor | None = None,  # (D, H, W) bool instance masks
    det_assoc: torch.Tensor | None = None,  # (D,) object slot per detection, -1 none
    num_samples: int = 256,
    recon_every: int = 2,
    min_obs: int = 2,
    draw: Draw = bbox_sample,
) -> ShapeInputs:
    """Sample each object's surface points and rays from this keyframe.

    A sample is a surface point when it has depth, lies above the ground
    and within 1.5 x the ellipsoid's largest half-axis of its centre; with
    instance masks it must also lie on a mask of a detection associated
    with this object (a later detection wins a pixel), while every sample
    with depth stays a render-term ray.  Without masks both sets are the
    geometric gate."""
    H, W = depth.shape
    O = table.ellipsoid.shape[0]
    dev = depth.device
    e_cam = quadric.transform_ellipsoid(table.ellipsoid, Tcw[None])
    bbox = quadric.project_bbox(e_cam, torch.eye(4, dtype=Tcw.dtype, device=dev), intrinsic_matrix(intr, dev))
    front = quadric.check_observability(table.ellipsoid, Tcw[None])
    due = table.valid & front & (table.obs_count >= min_obs) & ((table.obs_count % recon_every) == 0)

    count(HOST_READS)  # the draw's copy from host memory waits for the card
    unit = draw(gen, O, num_samples).to(dev)
    u = _scaled(unit[..., 0], bbox[:, 0:1], bbox[:, 2:3])
    v = _scaled(unit[..., 1], bbox[:, 1:2], bbox[:, 3:4])
    ui = torch.clamp(torch.round(u).to(torch.int32), 0, W - 1)
    vi = torch.clamp(torch.round(v).to(torch.int32), 0, H - 1)
    z = depth[vi.long(), ui.long()]
    uv = torch.stack([ui, vi], dim=-1).to(depth.dtype)
    pts = backproject(uv, z, intr)
    gdist = pts @ ground_cam[:3] + ground_cam[3]
    rad = torch.amax(e_cam[:, 6:9], dim=-1) * 1.5
    geom_ok = (z > 0.1) & (gdist > 0.03) & (torch.linalg.vector_norm(pts - e_cam[:, None, 0:3], dim=-1) < rad[:, None])
    if det_masks is not None and det_assoc is not None:
        # The owning slot of each sampled pixel: the last claiming detection.
        claim = det_masks[:, vi.long(), ui.long()] & (det_assoc >= 0)[:, None, None]  # (D, O, S)
        order = torch.arange(1, claim.shape[0] + 1, device=dev)[:, None, None]
        last = torch.amax(claim * order, dim=0) - 1
        owner = torch.where(last >= 0, det_assoc.to(torch.int64)[torch.clamp(last, min=0)], -1)
        ok = geom_ok & (owner == torch.arange(O, device=dev)[:, None])
        ray_ok = z > 0.1
    else:
        ok = ray_ok = geom_ok

    # Unit sphere -> world is sim(R_e, SCALE_MARGIN * max half-axis) at the centre.
    R_e = quadric.euler_to_rotmat(table.ellipsoid[:, 3:6])
    s = torch.amax(table.ellipsoid[:, 6:9], dim=-1) * SCALE_MARGIN
    T_ow = lie.inv_sim3(lie.rt_to_se3(R_e * s[:, None, None], table.ellipsoid[:, 0:3]))
    return ShapeInputs(T_oc_init=T_ow @ lie.inv_se3(Tcw), pts_cam=pts, pts_ok=ok & due[:, None],
                       rays=pixel_rays(uv, intr), depth_obs=z, rays_ok=ray_ok & due[:, None], due=due)


def keypoint_depth_image(xy: torch.Tensor, depth: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Stereo keypoint depths (F,) at their rounded pixels xy (F, 2) in a
    zero (H, W) image, the shape step's depth for a stereo keyframe.  Among
    keypoints sharing a pixel the last one wins, as the reference's
    `.at[yi, xi].set` does on XLA:CPU."""
    xi = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, width - 1)
    yi = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, height - 1)
    img = torch.zeros(height * width, dtype=torch.float32, device=depth.device)
    return scatter_set_last(img, yi * width + xi, depth).reshape(height, width)


def hypothesis_bytes(dec_cfg: DeepSDFConfig, num_points: int, num_rays: int) -> int:
    """Bytes of one hypothesis's LM trip on the CPU's forward-mode path
    (`shape_opt.forward_jacobian`): the primal and 7 + C tangents of a
    hidden layer at every decoder point, times WORKING_SET such layers.
    The H100 measured 3.14 on that path at the reference's width (3.91 GB
    per hypothesis of 8448 points)."""
    pts = num_points + num_rays * RENDER_SAMPLES
    return int(WORKING_SET * pts * (8 + dec_cfg.code_dim) * dec_cfg.hidden * 4)


def reverse_hypothesis_bytes(dec_cfg: DeepSDFConfig, num_points: int, num_rays: int) -> int:
    """Bytes of one hypothesis's LM trip on the card's reverse-mode path
    (`shape_opt.reverse_jacobian`): every layer's saved activation and the
    row's 7 + C Jacobian columns at every decoder point, times
    REVERSE_WORKING_SET (`chip_smoke.py` phase 16 holds each shape step's
    peak under this estimate)."""
    pts = num_points + num_rays * RENDER_SAMPLES
    return int(REVERSE_WORKING_SET * pts * (dec_cfg.num_layers * dec_cfg.hidden + 7 + dec_cfg.code_dim) * 4)


def chunk_size(dec_cfg: DeepSDFConfig, num_points: int, num_rays: int, device: torch.device) -> int:
    """Hypotheses per LM call: half the card's memory over the reverse
    path's bytes, or 4 GiB on the CPU over the forward path's."""
    if device.type == "cuda":
        budget = torch.cuda.get_device_properties(device).total_memory // 2
        return max(1, budget // reverse_hypothesis_bytes(dec_cfg, num_points, num_rays))
    return max(1, CPU_BUDGET_BYTES // hypothesis_bytes(dec_cfg, num_points, num_rays))


def reconstruct_due_objects(
    table: ObjectTable,
    inputs: ShapeInputs,
    params,
    dec_cfg: DeepSDFConfig,
    Tcw: torch.Tensor,
    opt_cfg: ShapeOptConfig = ShapeOptConfig(),
) -> ObjectTable:
    """Joint pose + code LM over the due objects x their `num_flips`
    orientation hypotheses; per object the lowest-cost converged
    hypothesis is folded back (code, Tow_shape = T_oc T_cw, shape_ok).
    One host read (`due`); no work when no object is due."""
    idx = torch.nonzero(fetch(inputs.due))[:, 0]
    n = int(idx.shape[0])
    if n == 0:
        return table
    count(HOST_READS)  # the index's copy back to the card waits for it too
    idx = idx.to(table.code.device)
    F = max(1, opt_cfg.num_flips)
    T_hyp = flip_hypotheses(inputs.T_oc_init[idx], F).reshape(n * F, 4, 4)
    args = [x[idx].repeat_interleave(F, dim=0) for x in (table.code, inputs.pts_cam, inputs.pts_ok, inputs.rays,
                                                          inputs.depth_obs, inputs.rays_ok)]
    step = chunk_size(dec_cfg, inputs.pts_cam.shape[1], inputs.rays.shape[1], table.code.device)
    parts = [reconstruct_object(params, dec_cfg, T_hyp[i:i + step], *(a[i:i + step] for a in args), opt_cfg)
             for i in range(0, n * F, step)]
    res = ShapeOptResult(*(torch.cat(xs).reshape((n, F) + xs[0].shape[1:]) for xs in zip(*parts)))
    pick = pick_flips(res)
    rows = torch.arange(n, device=pick.device)
    good = res.is_good[rows, pick]
    code = table.code.clone()
    code[idx] = torch.where(good[:, None], res.code[rows, pick], table.code[idx])
    Tow = table.Tow_shape.clone()
    Tow[idx] = torch.where(good[:, None, None], res.T_oc[rows, pick] @ Tcw, table.Tow_shape[idx])
    shape_ok = table.shape_ok.clone()
    shape_ok[idx] = shape_ok[idx] | good
    return table._replace(code=code, Tow_shape=Tow, shape_ok=shape_ok)
