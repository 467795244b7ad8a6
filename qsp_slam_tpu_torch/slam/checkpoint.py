"""Save and resume a session (counterpart of
`qsp_slam_tpu/slam/checkpoint.py`): the map, the snapshot store, the
object table, the Manhattan plane set and the object-plane relations,
the ground plane and the keyframes fused into it, the tracker's fields,
the sensor, the monocular bootstrap's reference frame and its age, the
loop count and the consistency gate's history, the stats, the trajectory
and the capacities, in one npz with the JAX package's keys (`map.*`,
`loop.*`, `obj.*`, `plane.*`, `rel.*`, `monoref.*`, `Tcw`, `sensor`,
`ground_plane`, `gp_count`, ...).  So a checkpoint the JAX package wrote
resumes in the port, which carries the state across as `convert.py`
does.  The port also keeps `gp_inliers`, the support of the monocular
ground plane (a JAX checkpoint resumes it at 0).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..convert import frame_from_numpy, loop_state_from_numpy, map_state_from_numpy, object_table_from_numpy
from ..perception.manhattan import PlaneSet, empty_plane_set
from ..perception.relations import Relations
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
    data.update(_flatten("obj.", system.objects))
    data.update(_flatten("plane.", system.plane_set))
    if system.relations is not None:
        data.update(_flatten("rel.", system.relations))
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
    if system.ground_plane is not None:
        data["ground_plane"] = system.ground_plane
    data["gp_count"] = np.asarray(system._gp_count)
    data["gp_inliers"] = np.asarray(system._gp_inliers)
    if system._mono_ref is not None:
        data.update(_flatten("monoref.", system._mono_ref))
        data["mono_ref_age"] = np.asarray(system._mono_ref_age)
    gate = system._loop_gate
    data["loop_gate_json"] = np.asarray(json.dumps(
        {"required": gate.required, "neighborhood": gate.neighborhood, "history": gate.history}))
    np.savez_compressed(path, **data)


def _tensors(cls, prefix: str, data: dict, device):
    return cls(**{k: torch.from_numpy(np.array(data[prefix + k])).to(device) for k in cls._fields})


def load_checkpoint(path: str, system) -> None:
    """Restore a session into a constructed SlamSystem, on its device.  The
    capacities come from the checkpoint, so a run that grew its stores
    resumes with the grown stores."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    _migrate_loop_state(data)
    system.map_state = map_state_from_numpy(_fields("map.", data), system.device)
    system.loop_state = loop_state_from_numpy(_fields("loop.", data), system.device)
    system.kmax, system.nmax, system.emax = system.map_state.capacity
    if "obj.valid" in data:
        system.objects = object_table_from_numpy(_fields("obj.", data), system.device)
        system.omax = int(system.objects.valid.shape[0])
    system.plane_set = (_tensors(PlaneSet, "plane.", data, system.device) if "plane.valid" in data
                        else empty_plane_set(8, device=system.device))
    system.relations = _tensors(Relations, "rel.", data, system.device) if "rel.kind" in data else None
    gp = data.get("ground_plane")
    system.ground_plane = None if gp is None else np.asarray(gp, np.float32)
    system._gp_count = int(data.get("gp_count", 0))
    system._gp_inliers = int(data.get("gp_inliers", 0))
    if "monoref.depth" in data:
        system._mono_ref = frame_from_numpy(_fields("monoref.", data), system.device)
        system._mono_ref_age = int(data["mono_ref_age"])
    else:
        system._mono_ref, system._mono_ref_age = None, 0
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
