"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: half
the image, 600 features, a decoder of code 8 and width 32, four LM trips
from a damping of 1 (so that each trip goes part of the way, as at the
cell's size) and two flips, a few dozen frames.  For the CPU tests only; the cells
themselves run at their configuration's sizes on the card."""

from __future__ import annotations

import torch

from port_bench.harness import cell as cell_mod

FRAMES = 44


def tiny_cell(workload: str, frames: int | None = None) -> dict:
    c = cell_mod.load_cell(workload)
    cfg = dict(c["config"])
    for k in ("Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy", "Camera.bf"):
        cfg[k] *= 0.5
    cfg["Camera.width"], cfg["Camera.height"] = cfg["Camera.width"] // 2, cfg["Camera.height"] // 2
    cfg.update({"ORBextractor.nFeatures": 600, "DeepSDF.CodeLength": 8, "DeepSDF.dims": [32, 32, 32],
                "DeepSDF.latent_in": [2], "Optimizer.num_iterations": 4, "Optimizer.flip_sample_num": 2,
                "Optimizer.lm_lambda0": 1.0})
    c["config"] = cfg
    c["traffic"] = dict(c["traffic"], frames=frames or FRAMES, min_box_pixels=100, texture_size=256)
    return c


def tiny_run(workload: str, seed: int = 99, fault=None, frames: int | None = None) -> dict:
    """One run over every frame (the window ends at the last whole period)."""
    torch.set_num_threads(4)
    return cell_mod.run(tiny_cell(workload, frames), seed, 1e9, False, device="cpu", fault=fault)
