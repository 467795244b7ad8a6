"""qsp_slam_tpu_torch — the PyTorch/CUDA port of qsp_slam_tpu.

The JAX package `qsp_slam_tpu` is the reference; this package keeps its
subpackage and module names so every function has a findable counterpart:

core        SE3/Sim3 Lie groups, pinhole camera, plane and quadric algebra
ops         hand-written CUDA kernels (FAST score + NMS, packed Hamming)
              with their plain PyTorch versions
opt         reprojection factors, pose-only LM, Schur local BA, Sim3
              solver, pose graph, quadric factors, joint camera-point-
              object BA
frontend    image pyramid, FAST, ORB, stereo, projection, mutual and
              epipolar matching, PnP, the two-view initializer
perception  ground-plane RANSAC, depth ellipsoid fits, Manhattan planes,
              object-plane relations, symmetry completion, aspect-prior
              (monocular) objects, LiDAR proposals
slam        SoA map, tracking, monocular bootstrap and triangulation,
              local and joint mapping, keyframe snapshots, place queries,
              relocalization, loop closing, object table, YAML config,
              checkpoints, facade
data        synthetic scene renderer (with table slabs) and its detector,
              TUM and KITTI readers, native PNG loader, trajectory/map
              files, the make_tum and make_kitti fabricators
eval        trajectory ATE and RPE, object-map precision, recall and IoU
run_tum, run_kitti, run_mono   the RGB-D, stereo and monocular command lines

Entry points run on CUDA unless the caller passes `device="cpu"`; there is
no silent CPU fallback (`resolve_device`).
"""

from __future__ import annotations

import torch

# The 3x3/4x4 geometry and the LM normal equations need full f32 products
# (the JAX package pins `jax_default_matmul_precision=highest` for the same
# reason).  TF32 keeps ~3 decimal digits: enough to break orthonormality
# and the Schur solve's conditioning.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless one is named.

    Raises when no device is named and CUDA is unavailable, so a CPU run
    is always something the caller asked for.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
