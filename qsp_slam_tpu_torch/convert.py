"""Carry state from the JAX package into the port.

The state is the map, the keyframe snapshot store, the object table, a
frame (the monocular bootstrap's reference), the configuration, the
DeepSDF decoder's weights and the learned detectors' weights.  The functions take the JAX objects as numpy
arrays or plain field dictionaries, so this module never imports JAX:

    map_state_from_numpy({k: np.asarray(v) for k, v in m._asdict().items()})
    loop_state_from_numpy({k: (v._asdict() if k == "db" else np.asarray(v))
                           for k, v in ls._asdict().items()})
    object_table_from_numpy({k: np.asarray(v) for k, v in t._asdict().items()})
    frame_from_numpy({"feats": f.feats._asdict(), "depth": ..., "u_right": ...})
    tracking_config_from_fields(cfg._asdict())
    deepsdf_params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    detector2d_params_from_numpy({k: np.asarray(v) for k, v in params.items()})
    detector3d_params_from_numpy({k: np.asarray(v) for k, v in params.items()})
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from . import resolve_device
from .frontend.orb import Features, OrbConfig
from .frontend.pyramid import PyramidConfig
from .perception.detector2d import params_from_numpy
from .slam.loop_closing import LoopState
from .slam.map import MapState
from .slam.objects import ObjectTable
from .slam.place_recognition import PlaceDatabase
from .slam.tracking import FrameData, TrackingConfig


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:  # packed descriptor words: same bits as int32
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def map_state_from_numpy(arrays: Mapping[str, Any], device=None) -> MapState:
    """MapState fields (numpy arrays, the JAX dtypes) -> port MapState."""
    dev = resolve_device(device)
    return MapState(**{k: _tensor(arrays[k], dev) for k in MapState._fields})


def loop_state_from_numpy(arrays: Mapping[str, Any], device=None) -> LoopState:
    """LoopState fields, with `db` a mapping of PlaceDatabase fields."""
    dev = resolve_device(device)
    db = arrays["db"]
    return LoopState(
        db=PlaceDatabase(**{k: _tensor(db[k], dev) for k in PlaceDatabase._fields}),
        **{k: _tensor(arrays[k], dev) for k in LoopState._fields if k != "db"},
    )


def object_table_from_numpy(arrays: Mapping[str, Any], device=None) -> ObjectTable:
    """ObjectTable fields (numpy arrays, the JAX dtypes) -> port ObjectTable."""
    dev = resolve_device(device)
    return ObjectTable(**{k: _tensor(arrays[k], dev) for k in ObjectTable._fields})


def frame_from_numpy(arrays: Mapping[str, Any], device=None) -> FrameData:
    """FrameData fields, with `feats` a mapping of Features fields."""
    dev = resolve_device(device)
    feats = arrays["feats"]
    return FrameData(feats=Features(**{k: _tensor(feats[k], dev) for k in Features._fields}),
                     depth=_tensor(arrays["depth"], dev), u_right=_tensor(arrays["u_right"], dev))


def _fields(x) -> dict:
    return dict(x._asdict()) if hasattr(x, "_asdict") else dict(x)


def tracking_config_from_fields(fields: Mapping[str, Any]) -> TrackingConfig:
    """TrackingConfig fields (nested OrbConfig / PyramidConfig given as
    NamedTuples or mappings) -> port TrackingConfig."""
    fields = _fields(fields)
    orb = _fields(fields.pop("orb", OrbConfig()))
    orb["pyramid"] = PyramidConfig(**_fields(orb.get("pyramid", PyramidConfig())))
    fields["dist_coef"] = tuple(float(c) for c in fields.get("dist_coef", (0.0,) * 5))
    return TrackingConfig(orb=OrbConfig(**orb), **fields)


def deepsdf_params_from_numpy(tree: Mapping[str, Any], device=None) -> dict:
    """The JAX decoder pytree `{"lin{i}": {"v", "g", "b"}}` as numpy ->
    the port's params (f32 tensors)."""
    dev = resolve_device(device)
    return {name: {k: torch.tensor(np.asarray(v), dtype=torch.float32, device=dev) for k, v in layer.items()}
            for name, layer in tree.items()}


def detector2d_params_from_numpy(arrays: Mapping[str, Any], device=None) -> dict:
    """The JAX 2D detector's params (HWIO conv weights) as numpy -> the
    port's (OIHW), f32 on `device`."""
    return params_from_numpy(arrays, device)


def detector3d_params_from_numpy(arrays: Mapping[str, Any], device=None) -> dict:
    """The JAX 3D detector's params as numpy -> the port's: HWIO conv
    weights to OIHW, the point MLP's dense `p1`/`p2` weights as they are."""
    return params_from_numpy(arrays, device)
