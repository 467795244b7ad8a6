#!/usr/bin/env python3
"""The joint pose + code LM at the decoder's full width (64/512/8) in the
JAX package and in the port, on the CPU: tests/test_shape.py's problem
(family shape 1's surface 1.8 m ahead at scale 0.35 with 2 mm noise, rays
and depths from the same points, the frame perturbed), eight LM trips.

    JAX_PLATFORMS=cpu python tools/shape_full_width.py [--dump FILE]

Without `--dump`: the toy decoder trained by the JAX package and carried
over, the problem drawn by `jax.random`, one start from a zero code.
With `--dump FILE` (written by `python3 chip_smoke.py --shape-dump FILE`):
the decoder, codes and half-axes trained on the card, the problem as
`chip_smoke.py` phase 16 draws it (`single_object_problem`), and two
starts, a zero code and shape 1's family code, as phase 16 runs them.

Prints one JSON line: per start and package the seconds (the JAX
package's include its compile), `is_good`, the final cost, the code's
norm, the SDF's minimum over 4096 points of the cube (below zero: the
shape has an inside) and the surface points' median |SDF|.  A few
minutes per run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    import qsp_slam_tpu  # noqa: F401  (pins the f32 matmul precision)
    from qsp_slam_tpu.core import lie as jlie
    from qsp_slam_tpu.models import deepsdf as jsdf
    from qsp_slam_tpu.models import shape_opt as jopt
    from qsp_slam_tpu_torch.convert import deepsdf_params_from_numpy
    from qsp_slam_tpu_torch.core import lie as tlie
    from qsp_slam_tpu_torch.models import deepsdf as tsdf
    from qsp_slam_tpu_torch.models import shape_opt as topt

    cfg, tcfg = jsdf.DeepSDFConfig(), tsdf.DeepSDFConfig()
    if args.dump:
        from chip_smoke import single_object_problem

        dump = torch.load(args.dump, weights_only=False)
        params = dump["params"]
        jparams = {k: {n: jnp.asarray(t.numpy()) for n, t in p.items()} for k, p in params.items()}
        problem = [x.numpy() for x in single_object_problem(dump["halves"])]
        starts = {"zero code": np.zeros(64, np.float32), "family code": dump["codes"][1].numpy()}
    else:
        jparams, codes, halves = jsdf.train_toy_decoder(jax.random.PRNGKey(0), cfg)
        params = deepsdf_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        T_co = jlie.exp_se3(jnp.asarray([0.1, -0.05, 1.8, 0.0, 0.5, 0.0]))
        d = jax.random.normal(jax.random.PRNGKey(2), (256, 3))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        pts = (d * halves[1]) @ (T_co[:3, :3] * 0.35).T + T_co[:3, 3]
        pts = pts + 0.002 * jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(2), 1), pts.shape)
        T0 = jlie.exp_sim3(jnp.asarray([0.06, -0.04, 0.08, 0.05, -0.08, 0.04, 0.1])) @ jlie.inv_sim3(
            T_co.at[:3, :3].multiply(0.35))
        problem = [np.asarray(x) for x in (T0, pts, jnp.ones(256, bool), pts / pts[:, 2:3], pts[:, 2])]
        starts = {"zero code": np.zeros(64, np.float32)}
    T0, pts, ok, rays, depth = problem
    cube = np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (4096, 3), minval=-1.0, maxval=1.0))
    out = {}
    for name, code in starts.items():
        t0 = time.perf_counter()
        r = jax.block_until_ready(jopt.reconstruct_object(jparams, cfg, *(jnp.asarray(x) for x in (
            T0, code, pts, ok, rays, depth, ok))))
        out[f"{name}, jax"] = {
            "s": time.perf_counter() - t0, "is_good": bool(r.is_good), "cost": float(r.cost),
            "code_norm": float(jnp.linalg.norm(r.code)),
            "sdf_min": float(jsdf.decode_sdf(jparams, cfg, r.code, jnp.asarray(cube)).min()),
            "surface_median": float(jnp.median(jnp.abs(jsdf.decode_sdf(
                jparams, cfg, r.code, jlie.transform_points(r.T_oc, jnp.asarray(pts))))))}
        t = {k: torch.from_numpy(np.array(v)) for k, v in dict(T0=T0, code=code, pts=pts, ok=ok, rays=rays,
                                                               depth=depth, cube=cube).items()}
        t0 = time.perf_counter()
        r = topt.reconstruct_object(params, tcfg, t["T0"], t["code"], t["pts"], t["ok"], t["rays"], t["depth"],
                                    t["ok"])
        out[f"{name}, port"] = {
            "s": time.perf_counter() - t0, "is_good": bool(r.is_good), "cost": float(r.cost),
            "code_norm": float(r.code.norm()),
            "sdf_min": float(tsdf.decode_sdf(params, tcfg, r.code, t["cube"]).min()),
            "surface_median": float(tsdf.decode_sdf(params, tcfg, r.code, tlie.transform_points(
                r.T_oc, t["pts"])).abs().median())}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
