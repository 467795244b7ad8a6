"""room_objects: a box room (textures drawn from `texture_seed`) with the
`objects` (half-axes, turn about the vertical, label) on the floor, evenly
round a ring of `ring_radius_m` about the room's centre, and a hand-held
camera orbiting that centre at `camera_height_m`, looking down at
`pitch_deg`, moving `step_m` per frame, so every object stays in view."""

from __future__ import annotations

import math

import numpy as np
import torch

from ...reference import geometry as geo
from ..generator import Camera, Scene, make_room


def make(p: dict, cam: Camera, device):
    """The orbit round a ring of objects -> (scene, T_cw (N, 4, 4) f64)."""
    hx, hy, hz = p["room_half_extent"]
    room = make_room(p["room_half_extent"], p["texture_size"], p["texture_period_m"],
                     np.random.default_rng(p["texture_seed"]), device)
    objs = p["objects"]
    els, labels = [], []
    for slot, o in enumerate(objs):
        half = o["half_axes_m"]
        phi = 2.0 * math.pi * slot / len(objs)
        r = p["ring_radius_m"]
        els.append([r * math.sin(phi), hy - half[1], r * math.cos(phi), 0.0, o["yaw_rad"], 0.0, *half])
        labels.append(int(o["label"]))
    scene = Scene(room, torch.tensor(np.array(els, np.float32).reshape(-1, 9), device=device),
                  torch.tensor(labels, dtype=torch.int32, device=device),
                  torch.tensor([115.0 + 55.0 * lb for lb in labels], dtype=torch.float32, device=device))
    h = p["camera_height_m"]
    radius = h / math.tan(math.radians(p["pitch_deg"]))
    poses = []
    for i in range(p["frames"]):
        th = math.radians(p["start_angle_deg"]) + i * p["step_m"] / radius
        eye = (radius * math.sin(th), hy - h, -radius * math.cos(th))
        poses.append(geo.look_at(eye, (0.0, hy, 0.0)))
    return scene, torch.stack(poses)
