"""Save and resume a point-only RGB-D or stereo session (counterpart of
`qsp_slam_tpu/slam/checkpoint.py`): the map, the snapshot store, the
tracker's fields, the sensor, the loop count and the consistency gate's
history, the stats, the trajectory and the capacities, in one npz with
the JAX package's keys (`map.*`, `loop.*`, `Tcw`, `sensor`,
`loops_closed`, `loop_gate_json`, ...).  So a checkpoint the JAX package
wrote for such a session resumes in the port, which carries the state
across as `convert.py` does.

A checkpoint with state of a later slice (a monocular session, live
objects) raises `NotImplementedError` naming the slice.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..convert import loop_state_from_numpy, map_state_from_numpy
from .loop_closing import ConsistencyGate


def _flatten(prefix: str, nt) -> dict:
    out = {}
    for name, val in nt._asdict().items():
        if hasattr(val, "_asdict"):
            out.update(_flatten(f"{prefix}{name}.", val))
        else:
            out[f"{prefix}{name}"] = val.detach().cpu().numpy()
    return out


def _fields(prefix: str, data: dict) -> dict:
    """Keys under `prefix`, nested one level per dot."""
    out: dict = {}
    for key, val in data.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split(".")
            d = out
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = val
    return out


def _migrate_loop_state(data: dict) -> None:
    """In place, for checkpoints of older builds: a missing `loop.kf_octave`
    becomes octave 0 (the strictest gate), and a place database in an older
    signature format is rebuilt from the snapshot descriptors."""
    if "loop.kf_desc" not in data:
        return
    if "loop.kf_octave" not in data:
        data["loop.kf_octave"] = np.zeros(data["loop.kf_feat_ok"].shape, np.int8)
    from .place_recognition import SIG_DIM, bow_signature, quantize_signature

    sig = data["loop.db.signatures"]
    if sig.shape[1] != SIG_DIM or sig.dtype != np.uint8 or "loop.db.df" not in data:
        desc = torch.from_numpy(np.asarray(data["loop.kf_desc"]))
        ok = torch.from_numpy(np.asarray(data["loop.kf_feat_ok"]))
        sigs = np.stack([quantize_signature(bow_signature(d, o)).numpy() for d, o in zip(desc, ok)])
        sigs[int(data["loop.db.count"]):] = 0
        data["loop.db.signatures"] = sigs
        data["loop.db.df"] = (sigs > 0).sum(0).astype(np.float32)


def save_checkpoint(path: str, system) -> None:
    """Persist a SlamSystem's session to one npz."""
    data = {}
    data.update(_flatten("map.", system.map_state))
    data.update(_flatten("loop.", system.loop_state))
    data["Tcw"] = system.Tcw
    data["velocity"] = system.velocity
    data["initialized"] = np.asarray(system.initialized)
    data["frames_since_kf"] = np.asarray(system.frames_since_kf)
    data["inliers_at_last_kf"] = np.asarray(system.inliers_at_last_kf)
    data["sensor"] = np.asarray(system._sensor)
    data["loops_closed"] = np.asarray(system.loops_closed)
    data["stats_json"] = np.asarray(json.dumps(system.stats))
    data["trajectory"] = np.stack(system.trajectory) if system.trajectory else np.zeros((0, 4, 4))
    data["kf_fresh"] = np.asarray(system._kf_fresh)
    gate = system._loop_gate
    data["loop_gate_json"] = np.asarray(json.dumps(
        {"required": gate.required, "neighborhood": gate.neighborhood, "history": gate.history}))
    np.savez_compressed(path, **data)


def _refuse_later(data: dict) -> None:
    sensor = str(data["sensor"]) if "sensor" in data else "rgbd"
    if sensor == "mono":
        raise NotImplementedError("a mono session resumes with ROADMAP slice 5 (monocular)")
    if "monoref.depth" in data:
        raise NotImplementedError("a monocular bootstrap reference resumes with ROADMAP slice 5 (monocular)")
    if ("obj.valid" in data and np.asarray(data["obj.valid"]).any()) or "ground_plane" in data:
        raise NotImplementedError("object state resumes with ROADMAP slice 6 (quadric objects)")


def load_checkpoint(path: str, system) -> None:
    """Restore a session into a constructed SlamSystem, on its device.  The
    capacities come from the checkpoint, so a run that grew its stores
    resumes with the grown stores."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    _refuse_later(data)
    _migrate_loop_state(data)
    system.map_state = map_state_from_numpy(_fields("map.", data), system.device)
    system.loop_state = loop_state_from_numpy(_fields("loop.", data), system.device)
    system.kmax, system.nmax, system.emax = system.map_state.capacity
    system.Tcw = np.asarray(data["Tcw"], np.float32)
    system.velocity = np.asarray(data["velocity"], np.float32)
    system.initialized = bool(data["initialized"])
    system.frames_since_kf = int(data["frames_since_kf"])
    system.inliers_at_last_kf = int(data["inliers_at_last_kf"])
    if "stats_json" in data:
        system.stats = json.loads(str(data["stats_json"]))
        # JSON turns the (tag, value) capacity-event tuples into lists.
        if system.stats.get("capacity_events") is not None:
            system.stats["capacity_events"] = [tuple(e) for e in system.stats["capacity_events"]]
    system.trajectory = list(data["trajectory"])
    system._kf_fresh = bool(data.get("kf_fresh", False))
    system._lost_streak = 0
    system._sensor = str(data["sensor"]) if "sensor" in data else "rgbd"
    system.loops_closed = int(data.get("loops_closed", 0))
    gate = ConsistencyGate()
    if "loop_gate_json" in data:
        g = json.loads(str(data["loop_gate_json"]))
        gate = ConsistencyGate(g["required"], g["neighborhood"])
        gate.history = [list(map(int, h)) for h in g["history"]]
    system._loop_gate = gate
