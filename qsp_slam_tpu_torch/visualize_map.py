"""Offline map browser, headless (counterpart of
`qsp_slam_tpu/visualize_map.py`): reads a saved `map.npz` and writes

* `map_points.ply`, `object_wireframes.ply`, `trajectory.ply`
  (`viz/export.export_scene`),
* `render_####.png`: the object map rendered from chosen keyframe cameras
  (`viz/object_render`): shaded ellipsoids, plus the DeepSDF shapes when
  the map carries codes (the decoder from `--checkpoint`, a reference-
  format state dict, or else the toy decoder trained here),

then prints one JSON line (`out`, `keyframes`, `points`, `objects`,
`renders`).  It runs on CUDA unless given `--cpu`.

    python -m qsp_slam_tpu_torch.visualize_map MAP.npz --out DIR
        [--checkpoint decoder.pth] [--views 0 -1] [--wh 640 480]
        [--intr FX FY CX CY] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace

import numpy as np
import torch


def shape_decoder(checkpoint: str | None, code_dim: int, device):
    """(params, DeepSDFConfig): the reference-width decoder from a
    checkpoint, or without one the toy decoder (16/96/6 family) trained on
    `device` as the synthetic pipeline trains it."""
    from .models.deepsdf import DeepSDFConfig, load_torch_checkpoint, train_toy_decoder

    if checkpoint:
        cfg = DeepSDFConfig(code_dim=code_dim)
        return load_torch_checkpoint(checkpoint, cfg, device), cfg
    cfg = DeepSDFConfig(code_dim=code_dim, hidden=96, num_layers=6, latent_in=(3,))
    params, _, _ = train_toy_decoder(0, cfg, num_shapes=8, steps=300, batch=512, device=device)
    return params, cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("map_npz")
    ap.add_argument("--out", default="map_viz")
    ap.add_argument("--checkpoint", default=None, help="DeepSDF weights (reference state-dict format)")
    ap.add_argument("--views", type=int, nargs="*", default=[0, -1],
                    help="keyframe indices to render from (negative = from the end)")
    ap.add_argument("--wh", type=int, nargs=2, default=[640, 480])
    ap.add_argument("--intr", type=float, nargs=4, default=[520.9, 521.0, 325.1, 249.7],
                    metavar=("FX", "FY", "CX", "CY"))
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    args = ap.parse_args(argv)

    from . import resolve_device
    from .core.camera import Intrinsics
    from .data.io import load_map
    from .slam.objects import empty_objects
    from .viz.export import export_scene
    from .viz.object_render import render_objects_png

    dev = resolve_device("cpu" if args.cpu else None)
    data = load_map(args.map_npz)
    os.makedirs(args.out, exist_ok=True)
    points = SimpleNamespace(pt_xyz=data["pt_xyz"], pt_valid=data["pt_valid"])

    O = len(data["obj_ellipsoid"]) if "obj_ellipsoid" in data else 0
    objects = None
    if O:
        code = data.get("obj_code")
        objects = empty_objects(O, code_dim=code.shape[1] if code is not None else 16, device=dev)
        fields = {k: data[f"obj_{k}"] for k in ("ellipsoid", "label", "prob", "valid")}
        if code is not None:
            fields.update(code=code, Tow_shape=data["obj_Tow_shape"], shape_ok=data["obj_shape_ok"])
        objects = objects._replace(**{k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in fields.items()})

    num_kfs = int(data.get("num_kfs", 0))
    export_scene(args.out, points, objects, trajectory=data["kf_Tcw"][:num_kfs] if num_kfs else None)

    shape_prior = None
    if objects is not None and bool(objects.shape_ok.any()):
        shape_prior = shape_decoder(args.checkpoint, objects.code.shape[1], dev)

    W, H = args.wh
    intr = Intrinsics(*(float(np.float32(v)) for v in args.intr))
    rendered = []
    if objects is not None and num_kfs:
        for v in args.views:
            k = v % num_kfs
            path = os.path.join(args.out, f"render_{k:04d}.png")
            render_objects_png(path, objects, data["kf_Tcw"][k], intr, H, W, shape_prior=shape_prior)
            rendered.append(path)

    out = {
        "out": args.out,
        "keyframes": num_kfs,
        "points": int(np.asarray(points.pt_valid).sum()),
        "objects": int(objects.valid.sum()) if objects is not None else 0,
        "renders": rendered,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
