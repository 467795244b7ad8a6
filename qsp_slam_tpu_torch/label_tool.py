"""Headless ground-truth labelling tool (counterpart of
`qsp_slam_tpu/label_tool.py`): the create / list / remove workflows of an
interactive labeller as a command line over the package's artifact
formats, with the JAX tool's printed lines and npz contents:

  detection caches (per-frame npz, the replay seam `data/io.py`):
    python -m qsp_slam_tpu_torch.label_tool det list  DIR [--frame N]
    python -m qsp_slam_tpu_torch.label_tool det add   DIR FRAME --bbox X0 Y0 X1 Y1 \
        --label L [--prob P]
    python -m qsp_slam_tpu_torch.label_tool det remove DIR FRAME INDEX

  GT object tables (npz with ellipsoid (O,9) + label (O,)):
    python -m qsp_slam_tpu_torch.label_tool gt list     FILE
    python -m qsp_slam_tpu_torch.label_tool gt add      FILE --ellipsoid 9xFLOAT \
        --label L
    python -m qsp_slam_tpu_torch.label_tool gt remove   FILE INDEX
    python -m qsp_slam_tpu_torch.label_tool gt from-map FILE --map MAP_NPZ
        (seed GT from a saved SLAM map's object table: label from the
         reconstruction)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


# ---------------------------------------------------------------------------
# Detection caches
# ---------------------------------------------------------------------------

def _det_path(d: str, frame: int) -> str:
    return os.path.join(d, f"{frame}.npz")


def det_list(args) -> None:
    from .data.io import load_detection_cache

    frames = (
        [args.frame]
        if args.frame is not None
        else sorted(
            int(f[:-4]) for f in os.listdir(args.dir) if f.endswith(".npz")
        )
    )
    for fr in frames:
        det = load_detection_cache(_det_path(args.dir, fr))
        for i, (b, l, p, v) in enumerate(
            zip(det["bbox"], det["label"], det["prob"], det["valid"])
        ):
            if not v and not args.all:
                continue
            print(
                f"frame {fr} det {i}: label={int(l)} prob={float(p):.2f} "
                f"bbox=({b[0]:.0f},{b[1]:.0f},{b[2]:.0f},{b[3]:.0f})"
                + ("" if v else " [invalid]")
            )


def det_add(args) -> None:
    from .data.io import load_detection_cache, save_detection_cache

    path = _det_path(args.dir, args.frame)
    if os.path.exists(path):
        det = load_detection_cache(path)
    else:
        det = {
            "bbox": np.zeros((0, 4), np.float32),
            "label": np.zeros(0, np.int32),
            "prob": np.zeros(0, np.float32),
            "valid": np.zeros(0, bool),
        }
    det = {
        "bbox": np.vstack([det["bbox"], np.asarray(args.bbox, np.float32)]),
        "label": np.append(det["label"], np.int32(args.label)),
        "prob": np.append(det["prob"], np.float32(args.prob)),
        "valid": np.append(det["valid"], True),
        **({"mask": det["mask"]} if "mask" in det else {}),
    }
    if "mask" in det:  # keep the mask stack aligned: new det gets empty mask
        H, W = det["mask"].shape[1:]
        det["mask"] = np.concatenate(
            [det["mask"], np.zeros((1, H, W), bool)], 0
        )
    save_detection_cache(path, det)
    print(f"frame {args.frame}: added det {len(det['label']) - 1}")


def det_remove(args) -> None:
    from .data.io import load_detection_cache, save_detection_cache

    path = _det_path(args.dir, args.frame)
    det = load_detection_cache(path)
    n = len(det["label"])
    if not (0 <= args.index < n):
        sys.exit(f"index {args.index} out of range (0..{n - 1})")
    keep = np.arange(n) != args.index
    det = {k: v[keep] for k, v in det.items()}
    save_detection_cache(path, det)
    print(f"frame {args.frame}: removed det {args.index} ({keep.sum()} left)")


# ---------------------------------------------------------------------------
# GT object tables
# ---------------------------------------------------------------------------

def _gt_load(path: str) -> dict:
    if os.path.exists(path):
        with np.load(path) as z:
            return {"ellipsoid": z["ellipsoid"], "label": z["label"]}
    return {
        "ellipsoid": np.zeros((0, 9), np.float32),
        "label": np.zeros(0, np.int32),
    }


def _gt_save(path: str, gt: dict) -> None:
    np.savez_compressed(path, **gt)


def gt_list(args) -> None:
    gt = _gt_load(args.file)
    for i, (e, l) in enumerate(zip(gt["ellipsoid"], gt["label"])):
        c, rpy, half = e[:3], e[3:6], e[6:9]
        print(
            f"obj {i}: label={int(l)} center=({c[0]:.2f},{c[1]:.2f},{c[2]:.2f})"
            f" rpy=({rpy[0]:.2f},{rpy[1]:.2f},{rpy[2]:.2f})"
            f" half=({half[0]:.2f},{half[1]:.2f},{half[2]:.2f})"
        )


def gt_add(args) -> None:
    gt = _gt_load(args.file)
    gt["ellipsoid"] = np.vstack(
        [gt["ellipsoid"], np.asarray(args.ellipsoid, np.float32)]
    )
    gt["label"] = np.append(gt["label"], np.int32(args.label))
    _gt_save(args.file, gt)
    print(f"added obj {len(gt['label']) - 1}")


def gt_remove(args) -> None:
    gt = _gt_load(args.file)
    n = len(gt["label"])
    if not (0 <= args.index < n):
        sys.exit(f"index {args.index} out of range (0..{n - 1})")
    keep = np.arange(n) != args.index
    _gt_save(args.file, {k: v[keep] for k, v in gt.items()})
    print(f"removed obj {args.index} ({keep.sum()} left)")


def gt_from_map(args) -> None:
    from .data.io import load_map

    m = load_map(args.map)
    valid = np.asarray(m["obj_valid"], bool)
    gt = {
        "ellipsoid": np.asarray(m["obj_ellipsoid"], np.float32)[valid],
        "label": np.asarray(m["obj_label"], np.int32)[valid],
    }
    _gt_save(args.file, gt)
    print(f"seeded {valid.sum()} objects from {args.map}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="label_tool")
    sub = ap.add_subparsers(dest="group", required=True)

    det = sub.add_parser("det").add_subparsers(dest="cmd", required=True)
    p = det.add_parser("list")
    p.add_argument("dir")
    p.add_argument("--frame", type=int, default=None)
    p.add_argument("--all", action="store_true")
    p.set_defaults(fn=det_list)
    p = det.add_parser("add")
    p.add_argument("dir")
    p.add_argument("frame", type=int)
    p.add_argument("--bbox", type=float, nargs=4, required=True)
    p.add_argument("--label", type=int, required=True)
    p.add_argument("--prob", type=float, default=1.0)
    p.set_defaults(fn=det_add)
    p = det.add_parser("remove")
    p.add_argument("dir")
    p.add_argument("frame", type=int)
    p.add_argument("index", type=int)
    p.set_defaults(fn=det_remove)

    gt = sub.add_parser("gt").add_subparsers(dest="cmd", required=True)
    p = gt.add_parser("list")
    p.add_argument("file")
    p.set_defaults(fn=gt_list)
    p = gt.add_parser("add")
    p.add_argument("file")
    p.add_argument("--ellipsoid", type=float, nargs=9, required=True)
    p.add_argument("--label", type=int, required=True)
    p.set_defaults(fn=gt_add)
    p = gt.add_parser("remove")
    p.add_argument("file")
    p.add_argument("index", type=int)
    p.set_defaults(fn=gt_remove)
    p = gt.add_parser("from-map")
    p.add_argument("file")
    p.add_argument("--map", required=True)
    p.set_defaults(fn=gt_from_map)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
