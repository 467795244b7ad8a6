"""The comparison that decides `correct`, run once the window has closed.

Each number is compared with its limit in `limits/<workload>.json` (a
number passes at or under its limit):

  k1_mismatch     score-map elements where K1's output on the sampled
                  window frames differs from the plain FAST + NMS of the
                  same levels, plus sampled frames with no K1 call and
                  calls whose levels are not the pyramids of the sensor's
                  K1 images (exact: limit 0);
  pyramid_gap     the largest gap between those levels and the
                  reference's pyramids of the frame's own images, in the
                  launch's order (gray levels);
  k2_mismatch     distances where the sampled K2 calls differ from the
                  popcount of the XOR of their descriptor words, plus
                  sampled frames with no K2 call (exact);
  shape_settings_mismatch  the window's shape steps' LM and decoder
                  settings that differ from the configuration's (trips,
                  flips, cost weights, priors, Huber widths, damping;
                  code size, width, layers, latent_in), plus steps whose
                  hypotheses are not due objects x the configured flips
                  (exact: limit 0);
  shape_cost_gap  over every hypothesis of every window shape step, the
                  largest relative gap between the cost the program's LM
                  reports and the reference's float64 cost of the same
                  hypothesis (T_oc, code) on the same points and rays,
                  with the configuration's weights;
  shape_lm_short_share  the share of the window's hypotheses whose LM
                  fell short by half: the reference's own float64 LM
                  (`reference/shape.py: lm`) runs the configured trips from
                  the hypothesis's start on the same points and rays, and a
                  hypothesis falls short where log(c0 / c_prog) <
                  log(c0 / c_ref) / 2 (c0 the start's cost, c_prog the
                  reference's cost at the program's final state, c_ref the
                  reference LM's final cost).  A share, since the float32
                  and float64 LMs part ways hypothesis by hypothesis
                  (PERF.md); a program that stops early or leaves a term out
                  falls short on many;
  shape_stall     the share of those hypotheses whose final state the
                  reference finds no cheaper than their start;
  shape_start_gap the largest gap between the hypotheses the LM started
                  from and the flips of the step's inputs (frames; codes
                  from the table before the step);
  shape_fold_gap  the largest gap between the table after the step and the
                  lowest-cost converged hypothesis of each due object;
  shape_input_gap the largest gap between the step's surface points, ray
                  depths and rays and the depth image the sensor says the
                  step was given (the frame's own for RGB-D, the captured
                  keypoint depth image for stereo);
  keypoint_depth_gap  where the sensor's depth image is the program's
                  (stereo), the median relative gap between its depths at
                  the window's shape steps and the scene's true depth at
                  the same pixels: a wrong baseline or a broken stereo
                  match moves it;
  pose_rmse_m     the window's tracked camera centres against the
                  traffic's true ones (metres, in the first camera's frame);
  object_centre_m the largest distance from a mapped object's centre to
                  the nearest true one, or from a true object's to the
                  nearest mapped one, at the window's end (metres);
  object_shape_gap for each true object and the mapped one nearest it,
                  the gap between their shape matrices R diag(a^2) R^T
                  (half-axes a, turn R), relative to the truth's (Frobenius
                  norms), the largest: the ellipsoids' axes and
                  orientation at the window's end.

Where the program's state is the only way in (the descriptor words K2
saw, the levels K1 saw, the LM's inputs), the reference follows it step
by step and the stage before is checked on its own (pyramid_gap,
shape_start_gap, shape_input_gap).  Poses and objects (the tracking,
local BA and object layers) are held to the traffic's truth.  PERF.md
gives the readings each limit was set from.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import geometry as geo
from ..reference import kernels as refk
from ..reference import shape as refs
from . import setup

def needed_flop(steps: list, dims: list, iters: int) -> float:
    """The decoder FLOP the window's shape steps need at the configuration's
    `iters` trips (metrics/flop.py)."""
    from ..metrics.flop import shape_step_flop

    total = 0.0
    for st in steps:
        if "chunks" in st:
            st["needed_flop"] = shape_step_flop(dims, iters, [(c[0][5].sum(-1), c[0][8].sum(-1))
                                                              for c in st["chunks"]])
            total += st["needed_flop"]
    return total


def _kernel_numbers(traffic, kern, cfg, sensor) -> dict:
    k1_bad, pyr_gap, k2_bad = 0, 0.0, 0
    shapes = setup.level_shapes(cfg)
    for call in kern.k1_calls:
        frame, dev = traffic.frames[call["frame"]], call["levels"][0].device
        ref_levels = [lv for i in sensor.K1_IMAGES
                      for lv in refk.pyramid(torch.as_tensor(frame[i]).to(dev, torch.float32), shapes)]
        for lv, ref_lv, outs in zip(call["levels"], ref_levels, call["out"]):
            pyr_gap = max(pyr_gap, float((lv - ref_lv).abs().max()))
            for t, o in zip(call["thresholds"], outs):
                k1_bad += int((o != refk.fast_nms(lv, t)).sum())
        if len(call["levels"]) != len(ref_levels):
            k1_bad += 1
    for call in kern.k2_calls_seen:
        k2_bad += int((call["out"].to(torch.int64) != refk.hamming(call["a"], call["b"])).sum())
    # A sampled frame whose kernel calls never reached the hooks counts against its kernel.
    k1_bad += len(kern.frames - {c["frame"] for c in kern.k1_calls})
    k2_bad += len(kern.frames - {c["frame"] for c in kern.k2_calls_seen})
    return {"k1_mismatch": k1_bad, "pyramid_gap": pyr_gap, "k2_mismatch": k2_bad,
            "k1_calls": len(kern.k1_calls), "k2_calls": len(kern.k2_calls_seen)}


def _settings_mismatch(st: dict, opt: dict, dec: dict, due: int) -> int:
    """The shape step's settings that differ from the configuration's, and
    a hypothesis count other than due objects x flips."""
    bad = sum(1 for k, v in opt.items() if getattr(st["opt_cfg"], k, None) != v)
    bad += sum(1 for k, v in dec.items()
               if tuple(np.atleast_1d(getattr(st["dec_cfg"], k, -1))) != tuple(np.atleast_1d(v)))
    return bad + int(st["hyps"] != due * max(1, opt["num_flips"]))


def _shape_numbers(cfg, sensor, traffic, s_weights, steps, captured, device) -> dict:
    d = setup.decoder_shape(cfg)
    opt = setup.shape_opt(cfg)
    wb = refs.decoder_weights(setup.decoder_weights(cfg, s_weights, device))
    cam = setup.camera(cfg)
    cost_gap = start_gap = fold_gap = input_gap = 0.0
    stalls = hyps = mismatch = 0
    lm_costs = []
    F = max(1, opt["num_flips"])
    for st in steps:
        if "chunks" not in st:
            continue
        inputs = st["inputs"]
        idx = torch.nonzero(inputs.due)[:, 0]
        bad = _settings_mismatch(st, opt, d, int(idx.shape[0]))
        mismatch += bad
        if bad:
            continue
        costs, goods, Ts, codes, T0s, c0s = [], [], [], [], [], []
        for args, res in st["chunks"]:
            T0, code0, pts, pok, rays, depth, rok = args[2:9]
            ref_fin = refs.cost(wb, d["latent_in"], opt, res.T_oc, res.code, pts, pok, rays, depth, rok)
            ref_0 = refs.cost(wb, d["latent_in"], opt, T0, code0, pts, pok, rays, depth, rok)
            prog = res.cost.to(torch.float64)
            cost_gap = max(cost_gap, float(((prog - ref_fin).abs() / ref_fin.abs().clamp(min=1e-30)).max()))
            stalls += int((ref_fin >= ref_0).sum())
            hyps += int(ref_fin.shape[0])
            # The reference's own LM over the configured trips from the same start and inputs.
            ref_lm = refs.lm(wb, d["latent_in"], opt, T0, code0, pts, pok, rays, depth, rok)[2]
            lm_costs.append(torch.stack([ref_0, ref_fin, ref_lm], -1))
            # The points against their rays and depths (and below, the depths against the frame).
            input_gap = max(input_gap, float((pts.double() - rays.double() * depth.double()[..., None]).abs().max()))
            costs.append(res.cost), goods.append(res.is_good), Ts.append(res.T_oc), codes.append(res.code)
            T0s.append(T0), c0s.append(code0)
        T0 = torch.cat(T0s).double()
        want0 = refs.flips(inputs.T_oc_init[idx], F).reshape(-1, 4, 4)
        start_gap = max(start_gap, float((T0 - want0).abs().max()),
                        float((torch.cat(c0s) - st["before"]["code"][idx].repeat_interleave(F, 0)).abs().max()))
        k = refs.pick(torch.cat(costs).reshape(-1, F), torch.cat(goods).reshape(-1, F))
        rows = torch.arange(idx.shape[0], device=k.device)
        good = torch.cat(goods).reshape(-1, F)[rows, k]
        code = torch.where(good[:, None], torch.cat(codes).reshape(-1, F, d["code_dim"])[rows, k],
                           st["before"]["code"][idx])
        Tow = torch.where(good[:, None, None],
                          torch.cat(Ts).double().reshape(-1, F, 4, 4)[rows, k] @ st["Tcw"].double(),
                          st["before"]["Tow_shape"][idx].double())
        fold_gap = max(fold_gap, float((st["after"]["code"][idx] - code).abs().max()),
                       float((st["after"]["Tow_shape"][idx].double() - Tow).abs().max()),
                       float((st["after"]["shape_ok"][idx] != (st["before"]["shape_ok"][idx] | good)).sum()))
        depth_img = sensor.shape_depth(traffic.frames[st["frame"]], captured.get(st["frame"]))
        if depth_img is None:  # the sensor's depth image never reached the hook
            input_gap = float("inf")
            continue
        depth_img = torch.as_tensor(depth_img).to(inputs.rays.device)
        u = torch.round(inputs.rays[..., 0].double() * cam.fx + cam.cx).long().clamp(0, cam.width - 1)
        v = torch.round(inputs.rays[..., 1].double() * cam.fy + cam.cy).long().clamp(0, cam.height - 1)
        sel = inputs.rays_ok | inputs.pts_ok
        input_gap = max(input_gap, float(torch.where(sel, (inputs.depth_obs - depth_img[v, u]).abs(), 0.0).max()))
    c = torch.cat(lm_costs) if lm_costs else torch.ones((1, 3), dtype=torch.float64)
    fell = torch.log(c[:, :1] / c[:, 1:].clamp(min=1e-300))  # (prog, ref) log reductions
    return {"shape_cost_gap": cost_gap, "shape_stall": stalls / max(hyps, 1), "shape_start_gap": start_gap,
            "shape_fold_gap": fold_gap, "shape_input_gap": input_gap, "shape_hypotheses": hyps,
            "shape_settings_mismatch": mismatch,
            "shape_lm_short_share": float((fell[:, 0] < 0.5 * fell[:, 1]).double().mean()), "lm_costs": c.tolist()}


def _keypoint_depth_numbers(traffic, captured: dict) -> dict:
    """The captured depth images' nonzero pixels against the true depth."""
    gaps = []
    for f, img in captured.items():
        truth = torch.as_tensor(traffic.depth[f]).to(img.device)
        seen = (img > 0) & (truth > 0)
        gaps.append(((img - truth).abs() / truth)[seen].double())
    gaps = torch.cat(gaps) if gaps else torch.zeros(0)
    return {"keypoint_depth_gap": float(gaps.median())} if gaps.numel() else {}


def _shape_matrix(e: np.ndarray, R0: np.ndarray) -> np.ndarray:
    """R diag(half-axes^2) R^T of ellipsoids (n, 9), turned by R0."""
    R = R0 @ geo.euler_to_rotmat(torch.as_tensor(e[:, 3:6])).numpy()
    return R @ (e[:, 6:9, None] ** 2 * np.swapaxes(R, -1, -2))


def truth_numbers(traffic, state: dict, window: list) -> dict:
    """Camera centres of the window's frames, and the mapped objects'
    centres, half-axes and turns, against the traffic's truth (in the
    first frame's camera)."""
    T0 = traffic.T_cw[0]
    est = state["trajectory"]
    err = []
    for r in window:
        gt = traffic.T_cw[r["frame"]] @ np.linalg.inv(T0)
        c_gt = -gt[:3, :3].T @ gt[:3, 3]
        e = est[r["frame"]].astype(np.float64)
        err.append(np.linalg.norm(-e[:3, :3].T @ e[:3, 3] - c_gt))
    true_e = traffic.ellipsoids
    true_c = (T0[:3, :3] @ true_e[:, :3].T).T + T0[:3, 3]
    obj = state["objects"]
    centre = shape_gap = 1e9  # no object mapped
    if len(obj):
        d = np.linalg.norm(true_c[:, None, :] - obj[None, :, :3], axis=-1)
        centre = float(max(d.min(0).max(), d.min(1).max()))
        # Each true object's nearest mapped one: the gap of their shape matrices, relative to the truth's.
        Q_true, Q_est = _shape_matrix(true_e, T0[:3, :3]), _shape_matrix(obj[d.argmin(1)], np.eye(3))
        shape_gap = float(np.max(np.linalg.norm(Q_est - Q_true, axis=(1, 2)) / np.linalg.norm(Q_true, axis=(1, 2))))
    return {"pose_rmse_m": float(np.sqrt(np.mean(np.square(err)))), "object_centre_m": centre,
            "object_shape_gap": shape_gap, "objects": len(obj)}


def compare(cfg, sensor, traffic, s_weights, steps, kern, captured, device) -> dict:
    """`captured`: the sensor's shape-step depth image by frame, where the
    sensor names one (`harness/sensors/`), else empty."""
    with torch.no_grad():
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        out = _kernel_numbers(traffic, kern, cfg, sensor)
        out.update(_shape_numbers(cfg, sensor, traffic, s_weights, steps, captured, device))
        out.update(_keypoint_depth_numbers(traffic, captured))
    return out
