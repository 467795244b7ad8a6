"""Per-sequence YAML configuration (counterpart of
`qsp_slam_tpu/slam/config.py`, `tracking_config_from_yaml`): the
reference's OpenCV-style keys map onto `TrackingConfig` fields, unknown
dotted keys warn, and keyword overrides win.  PyYAML is imported only when
a file is read.  `shape_config_from_json` reads the model-side JSON (the
reference's `configs/config_*.json` optimizer block) into a
`ShapeOptConfig`.
"""

from __future__ import annotations

import json
import warnings
from typing import Any

from ..frontend.orb import OrbConfig
from ..frontend.pyramid import PyramidConfig
from ..models.shape_opt import ShapeOptConfig
from .tracking import TrackingConfig

# YAML key -> TrackingConfig field; None = read below or ignored.
_YAML_KEYS = {
    "Camera.fx": "fx",
    "Camera.fy": "fy",
    "Camera.cx": "cx",
    "Camera.cy": "cy",
    "Camera.width": "width",
    "Camera.height": "height",
    "Camera.bf": None,  # baseline = bf / fx
    "Camera.k1": None,  # dist_coef = (k1, k2, p1, p2, k3)
    "Camera.k2": None,
    "Camera.p1": None,
    "Camera.p2": None,
    "Camera.k3": None,
    "ThDepth": None,
    "DepthMapFactor": None,
    "ORBextractor.nFeatures": ("orb", "num_features"),
    "ORBextractor.scaleFactor": ("orb", "pyramid", "scale_factor"),
    "ORBextractor.nLevels": ("orb", "pyramid", "num_levels"),
    "ORBextractor.iniThFAST": ("orb", "fast_threshold"),
    "ORBextractor.minThFAST": ("orb", "fast_threshold_min"),
}


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        text = f.read()
    if text.startswith("%YAML"):  # the OpenCV header of the reference's files
        text = "\n".join(text.splitlines()[1:])
    return yaml.safe_load(text) or {}


def tracking_config_from_yaml(path: str, **overrides: Any) -> TrackingConfig:
    """A TrackingConfig from a sequence YAML, then `overrides`."""
    raw = load_yaml(path)
    flat: dict[str, Any] = {}
    pyramid: dict[str, Any] = {}
    orb: dict[str, Any] = {}
    for key, val in raw.items():
        if key not in _YAML_KEYS:
            if "." in key:
                warnings.warn(f"config: unknown key {key!r} ignored")
            continue
        target = _YAML_KEYS[key]
        if target is None:
            continue
        if isinstance(target, tuple):
            if target[:2] == ("orb", "pyramid"):
                pyramid[target[2]] = val
            else:
                orb[target[1]] = val
        else:
            flat[target] = val
    if "Camera.bf" in raw and "Camera.fx" in raw:
        flat["baseline"] = float(raw["Camera.bf"]) / float(raw["Camera.fx"])
    if any(f"Camera.{k}" in raw for k in ("k1", "k2", "p1", "p2", "k3")):
        flat["dist_coef"] = tuple(
            float(raw.get(f"Camera.{k}", 0.0)) for k in ("k1", "k2", "p1", "p2", "k3")
        )
    for k in ("width", "height"):
        if f"Camera.{k}" in raw:
            flat[k] = int(raw[f"Camera.{k}"])
    if pyramid:
        if "num_levels" in pyramid:
            pyramid["num_levels"] = int(pyramid["num_levels"])
        base = PyramidConfig(height=int(flat.get("height", 480)), width=int(flat.get("width", 640)))
        orb["pyramid"] = base._replace(**pyramid)
    if orb:
        if "num_features" in orb:
            orb["num_features"] = int(orb["num_features"])
        flat["orb"] = OrbConfig()._replace(**orb)
    flat.update(overrides)
    return TrackingConfig()._replace(**flat)


# JSON optimizer key -> ShapeOptConfig field, converter.
_JSON_KEYS = {
    "num_iterations": ("iters", int),
    "k1": ("w_sdf", float),
    "k2": ("w_render", float),
    "k3": ("w_rot", float),
    "k4": ("w_code", float),
    "scale_damping": ("w_scale", float),
    "b1": ("huber_sdf", float),
    "b2": ("huber_render", float),
}


def shape_config_from_json(path: str) -> ShapeOptConfig:
    """A ShapeOptConfig from a model-side JSON: its "optimizer" block, or
    the top level when there is none; absent keys keep their defaults."""
    with open(path) as f:
        raw = json.load(f)
    opt = raw.get("optimizer", raw)
    return ShapeOptConfig()._replace(**{field: conv(opt[key]) for key, (field, conv) in _JSON_KEYS.items()
                                        if key in opt})
