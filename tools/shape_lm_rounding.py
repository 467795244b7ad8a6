#!/usr/bin/env python3
"""How the joint pose + code LM treats f32 rounding in the JAX package and
in the port, on the CPU: tests/test_shape.py's problem at the toy width
(16/96/6), its decoder trained by the JAX package and carried over.

    JAX_PLATFORMS=cpu python tools/shape_lm_rounding.py

Prints one JSON line with
- `trip3`: the third trip's system (from the reference's state after two
  trips) in each package against the port's float64 evaluation: the
  Jacobian's, H's, g's and the step's largest errors, and H's condition;
- `vs_f64`: per trip count 1-6, each package's code and frame against the
  port's float64 LM from the same start;
- `spread`: per trip count 2-4, over 20 one-ulp changes of the initial
  frame (the 3 x 4 block's entries that tests/test_torch_shape.py moves,
  up and down), the median and largest change of each package's code and
  frame, and the port's gap to the reference without a change.
About five minutes on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

ULP_SHIFTS = [(i, j, s) for i, j in [(0, 3), (1, 3), (2, 3), (0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (2, 0), (1, 0)]
              for s in (1, -1)]


def main() -> dict:
    import jax
    import jax.numpy as jnp
    import torch
    from torch.func import jvp, vmap

    jax.config.update("jax_platforms", "cpu")
    import qsp_slam_tpu  # noqa: F401  (pins the f32 matmul precision)
    from qsp_slam_tpu.core import lie as jlie
    from qsp_slam_tpu.models import deepsdf as jsdf
    from qsp_slam_tpu.models import losses as jloss
    from qsp_slam_tpu.models import shape_opt as jopt
    from qsp_slam_tpu_torch.convert import deepsdf_params_from_numpy
    from qsp_slam_tpu_torch.models import deepsdf as tsdf
    from qsp_slam_tpu_torch.models import losses as tloss
    from qsp_slam_tpu_torch.models import shape_opt as topt
    from qsp_slam_tpu_torch.opt.pose_opt import solve_or_nan

    torch.set_num_threads(4)
    jcfg = jsdf.DeepSDFConfig(code_dim=16, hidden=96, num_layers=6, latent_in=(3,))
    cfg = tsdf.DeepSDFConfig(*jcfg)
    jparams, _, halves = jsdf.train_toy_decoder(jax.random.PRNGKey(0), jcfg, num_shapes=6, steps=500, batch=512)
    params = deepsdf_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    T_co = jlie.exp_se3(jnp.asarray([0.1, -0.05, 1.8, 0.0, 0.5, 0.0]))
    key = jax.random.PRNGKey(2)
    d = jax.random.normal(key, (256, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    pts = (d * halves[1]) @ (T_co[:3, :3] * 0.35).T + T_co[:3, 3]
    pts = pts + 0.002 * jax.random.normal(jax.random.fold_in(key, 1), pts.shape)
    T_init = np.asarray(jlie.exp_sim3(jnp.asarray([0.06, -0.04, 0.08, 0.05, -0.08, 0.04, 0.1]))
                        @ jlie.inv_sim3(T_co.at[:3, :3].multiply(0.35)))
    pts = np.asarray(pts)
    depth, ok = pts[:, 2], np.ones(256, bool)
    rays = pts / depth[:, None]
    zero = np.zeros(16, np.float32)
    D, P = 23, 256

    def tt(x, dtype=torch.float32):
        x = torch.from_numpy(np.array(x))
        return x.to(dtype) if x.is_floating_point() else x

    def run_jax(T, iters):
        return jopt.reconstruct_object(jparams, jcfg, *(jnp.asarray(x) for x in (T, zero, pts, ok, rays, depth, ok)),
                                       jopt.ShapeOptConfig(iters=iters))

    def run_port(T, iters, dtype=torch.float32):
        p = {k: {n: t.to(dtype) for n, t in q.items()} for k, q in params.items()}
        return topt.reconstruct_object(p, cfg, tt(T, dtype), tt(zero, dtype), tt(pts, dtype), tt(ok), tt(rays, dtype),
                                       tt(depth, dtype), tt(ok), topt.ShapeOptConfig(iters=iters))

    # The third trip's system from the reference's state after two trips
    # (both accepted: lambda = 1e-2 * 0.33^2).
    two = run_jax(T_init, 2)
    T_b, code = np.asarray(two.T_oc), np.asarray(two.code)
    lm = 1e-2 * 0.33 * 0.33
    prior = np.zeros(D, np.float32)
    prior[3:5], prior[6], prior[7:] = 0.3, 10.0, 0.03
    theta = np.concatenate([np.zeros(7, np.float32), code])

    @jax.jit
    def jax_system():
        th = jnp.asarray(theta)
        fs = lambda t: jloss.sdf_residuals(jparams, jcfg, t[:7], t[7:], T_b, pts, ok)  # noqa: E731
        fr = lambda t: jloss.render_residuals(jparams, jcfg, t[:7], t[7:], T_b, rays, depth, ok)  # noqa: E731
        Js, Jr, rs, rr = jax.jacfwd(fs)(th), jax.jacfwd(fr)(th), fs(th), fr(th)
        ws, wr = jopt._huber_w(rs, 0.05) * ok, jopt._huber_w(rr, 0.15) * ok
        H = jnp.einsum("pi,p,pj->ij", Js, ws, Js) + jnp.einsum("ri,r,rj->ij", Jr, wr, Jr) + jnp.diag(prior)
        g = -(jnp.einsum("pi,p->i", Js, ws * rs) + jnp.einsum("ri,r->i", Jr, wr * rr)) - prior * th
        eye = jnp.eye(D)
        return jnp.concatenate([Js, Jr]), H, g, jnp.linalg.solve(H + lm * H * eye + 1e-8 * eye, g)

    def port_system(dtype):
        p = {k: {n: t.to(dtype) for n, t in q.items()} for k, q in params.items()}

        def res(t):
            return torch.cat(tloss.joint_residuals(p, cfg, t[:, :7], t[:, 7:], tt(T_b, dtype)[None], tt(pts, dtype)[None],
                                                   tt(ok)[None], tt(rays, dtype)[None], tt(depth, dtype)[None],
                                                   tt(ok)[None]), -1)

        eye = torch.eye(D, dtype=dtype)
        r, J = vmap(lambda v: jvp(res, (tt(theta, dtype)[None],), (v[None],)))(eye)
        r, J = r[0], J.permute(1, 2, 0)
        w = torch.cat([topt._huber_w(r[:, :P], 0.05), topt._huber_w(r[:, P:], 0.15)], -1)
        Jw = J * w[..., None]
        pr = tt(prior, dtype)
        H = J.transpose(-1, -2) @ Jw + torch.diag(pr)
        g = -(Jw.transpose(-1, -2) @ r[..., None])[..., 0] - pr * tt(theta, dtype)
        step = solve_or_nan(H + lm * H * eye + 1e-8 * eye, g)
        return J[0].numpy(), H[0].numpy(), g[0].numpy(), step[0].numpy()

    exact = [x.astype(np.float64) for x in port_system(torch.float64)]
    trip3 = {"H_cond": float(np.linalg.cond(exact[1] + lm * exact[1] * np.eye(D) + 1e-8 * np.eye(D))),
             "step_norm_max": float(np.abs(exact[3]).max())}
    for name, got in (("jax", [np.asarray(x) for x in jax_system()]), ("port", port_system(torch.float32))):
        trip3[name] = {k: float(np.abs(a - e).max()) for k, a, e in zip(("J", "H", "g", "step"), got, exact)}

    vs_f64 = {}
    for k in range(1, 7):
        ref64 = run_port(T_init, k, torch.float64)
        j, p = run_jax(T_init, k), run_port(T_init, k)
        vs_f64[k] = {f"{n}_{f}": float(np.abs(np.asarray(getattr(r, f)) - getattr(ref64, f).numpy()).max())
                     for n, r in (("jax", j), ("port", p)) for f in ("code", "T_oc")}

    spread = {}
    for k in (2, 3, 4):
        base = {"jax": run_jax(T_init, k), "port": run_port(T_init, k)}
        moves = {f"{n}_{f}": [] for n in base for f in ("code", "T_oc")}
        for i, j, s in ULP_SHIFTS:
            T = T_init.copy()
            T[i, j] = np.nextafter(T[i, j], np.float32(s * 100))
            for n, r in (("jax", run_jax(T, k)), ("port", run_port(T, k))):
                for f in ("code", "T_oc"):
                    moves[f"{n}_{f}"].append(float(np.abs(np.asarray(getattr(r, f))
                                                          - np.asarray(getattr(base[n], f))).max()))
        spread[k] = {m: {"median": float(np.median(v)), "max": max(v)} for m, v in moves.items()}
        for f in ("code", "T_oc"):
            spread[k][f"port_vs_jax_{f}"] = float(np.abs(np.asarray(getattr(base["port"], f))
                                                         - np.asarray(getattr(base["jax"], f))).max())
    out = {"trip3": trip3, "vs_f64": vs_f64, "spread": spread}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
