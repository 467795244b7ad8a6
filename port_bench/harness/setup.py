"""What a cell's configuration file turns into: the camera the generator
renders for, the decoder's weights (the benchmark's own, from the seed),
and the program's system built as the configuration states.

Configuration keys (each file lists them; `reduced` and `assumed` say
what differs from its source):
  sensor                        a module under `harness/sensors/`: "rgbd"
                                (gray and depth images) or "stereo" (a
                                rectified pair, baseline Camera.bf / fx)
  Camera.fx/fy/cx/cy, Camera.width/height, Camera.bf (baseline x fx),
  Camera.k1/k2/p1/p2[/k3]       the yaml's camera
  ThDepth, DepthMapFactor       close-depth factor, depth PNG scale
  ORBextractor.*                features, pyramid levels and scale, FAST thresholds
  DeepSDF.CodeLength/dims/latent_in   the decoder (hidden widths, one per hidden layer)
  Optimizer.num_iterations/flip_sample_num   the shape LM's trips and flips
  Optimizer.w_*/huber_*/lm_lambda0           the LM's cost weights, Huber
                                             widths, priors and first damping
  System.kmax/nmax/emax/depth_max_m/local_map_budget
  System.options                (optional) a dict of further `SlamSystem`
                                keyword arguments, such as the program's
                                port-only options, which are off unless
                                named here; each key must be a field of
                                `SlamSystem` that the keys above do not set
"""

from __future__ import annotations

import dataclasses

import torch

from ..reference import kernels as refk
from ..reference.shape import layer_dims
from ..traffic.generator import Camera
from . import sensors

# The `SlamSystem` arguments `build_system` sets from the keys above.
SET_HERE = ("cfg", "kmax", "nmax", "emax", "shape_prior", "device")


def sensor(cfg: dict):
    """The configuration's sensor module (`harness/sensors/<sensor>.py`)."""
    return sensors.load(cfg["sensor"])


def camera(cfg: dict) -> Camera:
    return Camera(float(cfg["Camera.fx"]), float(cfg["Camera.fy"]), float(cfg["Camera.cx"]),
                  float(cfg["Camera.cy"]), int(cfg["Camera.width"]), int(cfg["Camera.height"]),
                  float(cfg["Camera.bf"]) / float(cfg["Camera.fx"]))


def decoder_shape(cfg: dict) -> dict:
    dims = cfg["DeepSDF.dims"]
    return {"code_dim": int(cfg["DeepSDF.CodeLength"]), "hidden": int(dims[0]), "num_layers": len(dims) + 1,
            "latent_in": tuple(int(i) for i in cfg["DeepSDF.latent_in"])}


# ShapeOptConfig's names -> the configuration's keys.
LM_KEYS = {"iters": "Optimizer.num_iterations", "num_flips": "Optimizer.flip_sample_num",
           **{k: f"Optimizer.{k}" for k in ("w_sdf", "w_render", "w_rot", "w_code", "w_scale", "huber_sdf",
                                             "huber_render", "lm_lambda0")}}


def shape_opt(cfg: dict) -> dict:
    """The shape LM's settings as the configuration states them."""
    return {k: (int(cfg[key]) if k in ("iters", "num_flips") else float(cfg[key])) for k, key in LM_KEYS.items()}


def decoder_dims(cfg: dict) -> list[tuple[int, int]]:
    """(in, out) of each of the decoder's linear layers."""
    d = decoder_shape(cfg)
    return layer_dims(d["code_dim"], d["hidden"], d["num_layers"], d["latent_in"])


def decoder_weights(cfg: dict, seed: int, device) -> list:
    """[(v, g, b)] per layer: He-normal directions v drawn in one call
    from a generator on `device` seeded with `seed`, g = |v| per row, zero
    biases.  The same seed gives the same bits, so the reference makes
    them again rather than read the program's."""
    dims = decoder_dims(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(i * o for i, o in dims), generator=gen, device=device)
    out, at = [], 0
    for din, dout in dims:
        v = flat[at:at + din * dout].reshape(dout, din) * (2.0 / din) ** 0.5
        at += din * dout
        out.append((v, torch.linalg.vector_norm(v, dim=1), torch.zeros(dout, device=device)))
    return out


def system_options(cfg: dict, system_cls) -> dict:
    """`System.options`, each key checked against `system_cls`'s fields."""
    options = dict(cfg.get("System.options", {}))
    fields = {f.name for f in dataclasses.fields(system_cls) if f.init}
    bad = sorted(k for k in options if k not in fields or k in SET_HERE)
    if bad:
        raise ValueError(f"System.options names {bad}: not keyword arguments of {system_cls.__name__} that "
                         f"the configuration's other keys leave unset")
    return options


def build_system(cfg: dict, raw_weights: list, device):
    """The program's `SlamSystem` with the configuration's tracking,
    capacities, shape prior and `System.options`."""
    from qsp_slam_tpu_torch.frontend.orb import OrbConfig
    from qsp_slam_tpu_torch.frontend.pyramid import PyramidConfig
    from qsp_slam_tpu_torch.models.deepsdf import DeepSDFConfig
    from qsp_slam_tpu_torch.models.shape_opt import ShapeOptConfig
    from qsp_slam_tpu_torch.slam.system import SlamSystem
    from qsp_slam_tpu_torch.slam.tracking import TrackingConfig

    cam = camera(cfg)
    dist = tuple(float(cfg.get(k, 0.0)) for k in ("Camera.k1", "Camera.k2", "Camera.p1", "Camera.p2", "Camera.k3"))
    track = TrackingConfig(
        orb=OrbConfig(num_features=int(cfg["ORBextractor.nFeatures"]),
                      pyramid=PyramidConfig(num_levels=int(cfg["ORBextractor.nLevels"]),
                                            scale_factor=float(cfg["ORBextractor.scaleFactor"]),
                                            height=cam.height, width=cam.width),
                      fast_threshold=float(cfg["ORBextractor.iniThFAST"]),
                      fast_threshold_min=float(cfg["ORBextractor.minThFAST"])),
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width, height=cam.height,
        baseline=cam.baseline, depth_max=float(cfg["System.depth_max_m"]),
        local_map_budget=int(cfg["System.local_map_budget"]), close_depth_factor=float(cfg["ThDepth"]),
        dist_coef=dist, depth_png_scale=float(cfg.get("DepthMapFactor", 5000.0)))
    options = system_options(cfg, SlamSystem)
    dec = DeepSDFConfig(**decoder_shape(cfg))
    opt = ShapeOptConfig(**shape_opt(cfg))
    params = {f"lin{i}": {"v": v, "g": g, "b": b} for i, (v, g, b) in enumerate(raw_weights)}
    return SlamSystem(track, kmax=int(cfg["System.kmax"]), nmax=int(cfg["System.nmax"]),
                      emax=int(cfg["System.emax"]), shape_prior=(params, dec, opt), device=str(device), **options)


def level_shapes(cfg: dict) -> list[tuple[int, int]]:
    """(H, W) of each pyramid level of one image."""
    return refk.level_shapes(int(cfg["Camera.height"]), int(cfg["Camera.width"]), int(cfg["ORBextractor.nLevels"]),
                             float(cfg["ORBextractor.scaleFactor"]))


def k1_level_shapes(cfg: dict) -> list[tuple[int, int]]:
    """(H, W) of each level one K1 launch covers: one image's pyramid for
    each image of the sensor's launch (`K1_IMAGES`), in the launch's order."""
    return level_shapes(cfg) * len(sensor(cfg).K1_IMAGES)
