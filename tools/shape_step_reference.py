#!/usr/bin/env python3
"""One full-width shape step of `chip_smoke.py` phase 16, replayed on the
CPU through the JAX package's `reconstruct_due_objects` and the port's.

`python3 chip_smoke.py --shape-dump FILE` saves the first shape step that
has due objects: the keyframe's `ShapeInputs`, the object table before
the step, T_cw, the step's `ShapeOptConfig`, the decoder's parameters
and the card's table after the step.  This script runs the same step on
the CPU with the decoder carried over, one due slot at a time (the
reference's result for a slot does not depend on the other slots), and
prints one JSON line: per slot and per run (`card`, `port_cpu`, `jax`)
`shape_ok`, the code's norm, the SDF's minimum over 4096 points of the
cube (below zero: the shape has an inside) and the median |SDF| of the
nearest true ellipsoid's surface through `Tow_shape`.

    JAX_PLATFORMS=cpu python tools/shape_step_reference.py FILE [--only jax|port|card]

`--only` runs one of the two CPU replays, or neither (`card`: the card's
readings alone).

At the decoder's full width each hypothesis takes minutes on the CPU:
about half an hour for three due objects x four flips.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _readings(decode, code, Tow, truth_pts) -> dict:
    """Code norm, SDF minimum over the cube, true-surface median |SDF|."""
    cube, surface = truth_pts
    return {"code_norm": float(np.linalg.norm(code)), "sdf_min": float(np.min(decode(code, cube))),
            "surface_median": float(np.median(np.abs(decode(code, surface @ Tow[:3, :3].T + Tow[:3, 3]))))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("dump")
    ap.add_argument("--only", choices=("jax", "port", "card"), default=None)
    args = ap.parse_args(argv)
    import torch

    from qsp_slam_tpu_torch.core import quadric
    from qsp_slam_tpu_torch.models import deepsdf as tsdf
    from qsp_slam_tpu_torch.models.shape_opt import ShapeOptConfig
    from qsp_slam_tpu_torch.slam import shape_mapping as tmap
    from qsp_slam_tpu_torch.slam.objects import ObjectTable

    torch.set_num_threads(4)
    dump = torch.load(args.dump, weights_only=False)
    st = dump["steps"][0]
    params = dump["params"]
    cfg = tsdf.DeepSDFConfig(code_dim=int(st["table"]["code"].shape[1]), hidden=int(params["lin1"]["v"].shape[1]),
                             num_layers=len(params))
    opt = ShapeOptConfig(*st["opt"])
    due = torch.nonzero(st["inputs"].due)[:, 0].tolist()
    cube = (2.0 * torch.rand(4096, 3, generator=torch.Generator().manual_seed(1)) - 1.0).numpy()
    truth = np.asarray(dump["truth"])
    surf = {}
    for o in due:  # 200 points of the nearest true ellipsoid's surface, as chip_smoke's surface_sdf
        e = st["table"]["ellipsoid"][o].numpy()
        j = int(np.linalg.norm(truth[:, :3] - e[:3], axis=1).argmin())
        d = np.random.default_rng(o).normal(size=(200, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        S = quadric.similarity_transform(torch.from_numpy(truth[j])).numpy()
        surf[o] = (cube, (d @ S[:3, :3].T + S[:3, 3]).astype(np.float32))

    def tdecode(code, xyz):
        return tsdf.decode_sdf(params, cfg, torch.as_tensor(code), torch.as_tensor(xyz)).numpy()

    out = {"frame": st["frame"], "due": due, "decoder": list(cfg[:3]), "opt_iters": opt.iters, "slots": {}}
    for o in due:
        after = st["after"]
        out["slots"][o] = {"card": dict(shape_ok=bool(after["shape_ok"][o]),
                                        **_readings(tdecode, after["code"][o].numpy(),
                                                    after["Tow_shape"][o].numpy(), surf[o]))}
    if args.only in (None, "port"):
        table = ObjectTable(**st["table"])
        t0 = time.perf_counter()
        res = tmap.reconstruct_due_objects(table, st["inputs"], params, cfg, st["Tcw"], opt)
        out["port_cpu_s"] = time.perf_counter() - t0
        for o in due:
            out["slots"][o]["port_cpu"] = dict(shape_ok=bool(res.shape_ok[o]), **_readings(
                tdecode, res.code[o].numpy(), res.Tow_shape[o].numpy(), surf[o]))
    if args.only in (None, "jax"):
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_platforms", "cpu")
        import qsp_slam_tpu  # noqa: F401  (pins the f32 matmul precision)
        from qsp_slam_tpu.models import deepsdf as jsdf
        from qsp_slam_tpu.models import shape_opt as jopt
        from qsp_slam_tpu.slam import objects as jobj
        from qsp_slam_tpu.slam import shape_mapping as jmap

        jcfg = jsdf.DeepSDFConfig(*cfg)
        jparams = {k: {n: jnp.asarray(t.numpy()) for n, t in p.items()} for k, p in params.items()}
        omax = int(st["table"]["valid"].shape[0])
        t0 = time.perf_counter()
        for o in due:
            one = {k: jnp.asarray(v.numpy()[o:o + 1] if v.dim() and v.shape[0] == omax else v.numpy())
                   for k, v in st["table"].items()}
            one["num_objects"] = jnp.asarray(1, one["num_objects"].dtype)
            jt = jobj.ObjectTable(**one)
            jin = jmap.ShapeInputs(*(jnp.asarray(x.numpy()[o:o + 1]) for x in st["inputs"]))
            res = jmap.reconstruct_due_objects(jt, jin, jparams, jcfg, jnp.asarray(st["Tcw"].numpy()),
                                               jopt.ShapeOptConfig(*st["opt"]))
            jdec = lambda c, x: np.asarray(jsdf.decode_sdf(jparams, jcfg, jnp.asarray(c), jnp.asarray(x)))  # noqa: E731
            out["slots"][o]["jax"] = dict(shape_ok=bool(res.shape_ok[0]), **_readings(
                jdec, np.asarray(res.code[0]), np.asarray(res.Tow_shape[0]), surf[o]))
        out["jax_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
