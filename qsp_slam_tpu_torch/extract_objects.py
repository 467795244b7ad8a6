"""Offline object-mesh extraction from a saved map (counterpart of
`qsp_slam_tpu/extract_objects.py`): each valid object's persisted code is
decoded on a grid, its surface extracted, and the mesh written in the
world frame (the inverse of its `Tow_shape`) as `object_<slot>.ply`; one
JSON line (`meshes_written`, `out`).  The decoder comes from
`--checkpoint` (a reference-format state dict) or is the toy decoder
trained here, as `run_synthetic` trains it.  It runs on CUDA unless given
`--cpu`.

    python -m qsp_slam_tpu_torch.extract_objects MAP.npz --out DIR
        [--checkpoint decoder.pth] [--resolution 64] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("map_npz")
    ap.add_argument("--out", default="objects_out")
    ap.add_argument("--checkpoint", default=None, help="DeepSDF weights (reference state-dict format)")
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of CUDA")
    args = ap.parse_args(argv)

    from . import resolve_device
    from .core import lie
    from .data.io import load_map
    from .models.mesh import extract_mesh_from_code
    from .viz.export import save_ply_mesh
    from .visualize_map import shape_decoder

    dev = resolve_device("cpu" if args.cpu else None)
    data = load_map(args.map_npz)
    codes = next((data[k] for k in ("obj_code", "obj_codes", "obj.code") if k in data), None)
    if codes is None:
        raise SystemExit("map has no object codes")
    valid = data.get("obj_valid", data.get("obj.valid"))
    shape_ok = data.get("obj_shape_ok", data.get("obj.shape_ok", np.ones(len(codes), bool)))
    Tow = data.get("obj_Tow_shape", data.get("obj.Tow_shape", np.tile(np.eye(4, dtype=np.float32), (len(codes), 1, 1))))

    params, cfg = shape_decoder(args.checkpoint, codes.shape[1], dev)
    os.makedirs(args.out, exist_ok=True)
    count = 0
    for i in np.where(valid & shape_ok)[0]:
        mesh = extract_mesh_from_code(params, cfg, torch.from_numpy(codes[i]).to(dev), resolution=args.resolution)
        if len(mesh.vertices) == 0:
            continue
        # normalized object frame -> world: the inverse of Tow_shape (Sim(3))
        T_wo = lie.inv_sim3(torch.from_numpy(np.asarray(Tow[i], np.float32))).numpy()
        verts_w = mesh.vertices @ T_wo[:3, :3].T + T_wo[:3, 3]
        save_ply_mesh(os.path.join(args.out, f"object_{i}.ply"), verts_w, mesh.faces)
        count += 1
    print(json.dumps({"meshes_written": count, "out": args.out}))
    return count


if __name__ == "__main__":
    main()
