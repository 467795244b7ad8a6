#!/usr/bin/env python3
"""How the RGB-D object refinement (`refine_objects`, 8 LM trips over each
object's box history, gravity and support priors) treats f32 rounding, in
the JAX package and in the port, on the CPU.

The scene is `chip_smoke.py` phase 17's (tests/test_shape_mapping.py's
three objects, 25 degrees down, 4 cm per frame, 500 features), rendered
here on the CPU.  The port's system runs 10 frames and keeps the inputs
of each `refine_objects` call; the second call (keyframe 3, the first
where the objects hold two boxes) is the one whose output parts card vs
CPU (`chip_smoke.py: object_step_trace`).

    JAX_PLATFORMS=cpu python tools/refine_rounding.py

Prints one JSON line with
- `spread`: over 20 random changes of at most one ulp of every entry of
  the starting ellipsoids, the median and largest move of the refined
  centres, Euler angles and half-axes of the refined objects, in each
  package (each package from its own unchanged output);
- `port_vs_jax`: the two packages' outputs on the same inputs;
- `lm`: per LM trip of the port on the unchanged inputs, H's condition
  number (with the 1e-8 damping floor) and the relative cost change of
  each refined object (a trip is accepted when it is positive).
About a minute on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

TRIALS = 20


def scene_calls():
    """The port's refine_objects inputs of phase 17's 10 frames, on the CPU."""
    import torch

    from qsp_slam_tpu_torch.core import lie
    from qsp_slam_tpu_torch.data.render import gt_detections, make_scene, render_scene
    from qsp_slam_tpu_torch.frontend.orb import OrbConfig
    from qsp_slam_tpu_torch.slam import system as system_mod
    from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

    cfg = TrackingConfig(orb=OrbConfig(num_features=500))
    scene = make_scene(num_objects=3, seed=2, device="cpu")
    base = lie.exp_se3(torch.tensor([0, 0, 0, 0.44, 0, 0], dtype=torch.float32))
    calls, real = [], system_mod.refine_objects

    def keep(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    system_mod.refine_objects = keep
    try:
        sysm = system_mod.SlamSystem(cfg, device="cpu")
        for i in range(10):
            Tcw = (lie.exp_se3(torch.tensor([0.04 * i, 0, 0, 0, 0, 0], dtype=torch.float32)) @ base).numpy()
            g, d, inst = render_scene(scene, Tcw, cfg.intr)
            det = gt_detections(scene, Tcw, cfg.intr, instance=inst)
            sysm.track_rgbd(g.numpy(), d.numpy(), {k: v.numpy() for k, v in det.items()})
    finally:
        system_mod.refine_objects = real
    return calls


def parts(d: np.ndarray) -> dict:
    return {"centre": float(d[..., :3].max(initial=0.0)), "euler": float(d[..., 3:6].max(initial=0.0)),
            "half_axes": float(d[..., 6:9].max(initial=0.0))}


def main() -> dict:
    import jax.numpy as jnp
    import torch
    from torch.func import jvp, vmap

    from qsp_slam_tpu.slam import objects as jobj
    from qsp_slam_tpu_torch.opt import quadric_factors as qf
    from qsp_slam_tpu_torch.slam import objects as tobj

    (table, K, pi_w), kw = scene_calls()[1]
    live = (table.valid & ~table.dynamic & (torch.sum(table.obs_weight > 0, -1) >= 2)).numpy()
    support = kw.get("support_planes_w")
    jtable = jobj.ObjectTable(**{f: jnp.asarray(getattr(table, f).numpy()) for f in table._fields})

    def jax_refine(t):
        return np.asarray(jobj.refine_objects(t, jnp.asarray(K.numpy()), jnp.asarray(pi_w.numpy()),
                                              support_planes_w=None if support is None
                                              else jnp.asarray(support.numpy()), img_wh=kw.get("img_wh")).ellipsoid)

    def port_refine(t):
        return tobj.refine_objects(t, K, pi_w, **kw).ellipsoid.numpy()

    e0 = table.ellipsoid.numpy()
    out = {"port": port_refine(table), "jax": jax_refine(jtable)}
    rng = np.random.default_rng(0)
    moves = {"port": [], "jax": []}
    for _ in range(TRIALS):
        step = rng.integers(-1, 2, e0.shape)  # -1, 0 or +1 ulp per entry
        e = np.where(step > 0, np.nextafter(e0, np.inf), np.where(step < 0, np.nextafter(e0, -np.inf), e0))
        e = e.astype(np.float32)
        moves["port"].append(np.abs(port_refine(table._replace(ellipsoid=torch.from_numpy(e))) - out["port"])[live])
        moves["jax"].append(np.abs(jax_refine(jtable._replace(ellipsoid=jnp.asarray(e))) - out["jax"])[live])
    spread = {}
    for pkg, m in moves.items():
        m = np.stack(m)
        spread[pkg] = {"median": {k: float(np.median([parts(x)[k] for x in m])) for k in ("centre", "euler",
                                                                                          "half_axes")},
                       "max": parts(m)}

    # The port's LM on the unchanged inputs, trip by trip.
    trips = []
    real = qf.lm_refine

    def traced(residual, e_init, lmbda0, iters):
        O = e_init.shape[0]
        basis = torch.eye(9, dtype=e_init.dtype)
        eye = basis.expand(O, 9, 9)

        def cost(e):
            r = residual(e)
            return torch.sum(r * r, dim=-1)

        e, lm, c = e_init, torch.full((O,), lmbda0), cost(e_init)
        for _ in range(iters):
            r, J = vmap(lambda v: jvp(residual, (e,), (v.expand(O, 9),)))(basis)
            J = J.permute(1, 2, 0)
            H = J.transpose(-1, -2) @ J
            g = -(J.transpose(-1, -2) @ r[0][..., None])
            delta = torch.linalg.solve_ex(H + lm[:, None, None] * H * eye + 1e-8 * eye, g)[0][..., 0]
            e_try = torch.cat([(e + delta)[:, :6], torch.clamp((e + delta)[:, 6:9], 0.02, 5.0)], dim=-1)
            c_try = cost(e_try)
            accept = c_try < c
            trips.append({"cond": [float(f"{x:.3g}") for x in torch.linalg.cond((H + 1e-8 * eye)[live_t]).tolist()],
                          "rel_gain": [float(f"{x:.3g}") for x in ((c - c_try) / c)[live_t].tolist()]})
            e = torch.where(accept[:, None], e_try, e)
            lm = torch.clamp(torch.where(accept, lm * 0.33, lm * 3.0), 1e-7, 1e6)
            c = torch.where(accept, c_try, c)
        return e, c

    live_t = torch.from_numpy(live)
    qf.lm_refine = traced
    try:
        port_refine(table)
    finally:
        qf.lm_refine = real
    res = {"refined_objects": int(live.sum()), "spread": spread,
           "port_vs_jax": parts(np.abs(out["port"] - out["jax"])[live]), "lm": trips}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
