"""Mesh extraction from a latent code (counterpart of
`qsp_slam_tpu/models/mesh.py`): the SDF decoded on a regular grid in
chunks, then the iso-surface by the repository's native marching
tetrahedra (`native/marching_cubes.cpp`, unchanged).  The port compiles
its own copy of that source with `g++` into
`_build/libqsp_mc-<hash>.so` at first use (see `data/native_loader.py`)
and never uses the reference's `make` build.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..data.native_loader import shared_library
from ..perception.ellipsoid_fit import jax_linspace
from .deepsdf import DeepSDFConfig, decode_sdf, weights

SOURCE = Path(__file__).resolve().parents[2] / "native" / "marching_cubes.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class Mesh(NamedTuple):
    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (T, 3) int32


def library() -> ctypes.CDLL:
    """The loaded marching-cubes library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(shared_library(SOURCE, "qsp_mc")))
            f_p, i_p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
            lib.marching_cubes.restype = ctypes.c_int
            lib.marching_cubes.argtypes = [f_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           f_p, i_p, ctypes.c_int, ctypes.c_int, i_p, i_p]
            _lib = lib
        return _lib


def marching_cubes(sdf_grid: np.ndarray, iso: float = 0.0) -> Mesh:
    """The iso-surface of a (nz, ny, nx)-indexed SDF grid; vertices in
    (x, y, z) voxel coordinates."""
    lib = library()
    sdf = np.ascontiguousarray(sdf_grid, dtype=np.float32)
    if sdf.ndim != 3:
        raise ValueError(f"marching_cubes needs a 3-D grid, got shape {sdf.shape}")
    nz, ny, nx = sdf.shape
    vert_cap = max(1 << 16, 8 * nx * ny)
    tri_cap = 2 * vert_cap
    verts = np.empty((vert_cap, 3), np.float32)
    tris = np.empty((tri_cap, 3), np.int32)
    nv, nt = ctypes.c_int(0), ctypes.c_int(0)
    f_p, i_p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    status = lib.marching_cubes(sdf.ctypes.data_as(f_p), nx, ny, nz, ctypes.c_float(iso), verts.ctypes.data_as(f_p),
                                tris.ctypes.data_as(i_p), vert_cap, tri_cap, ctypes.byref(nv), ctypes.byref(nt))
    if status != 0:
        raise RuntimeError("marching_cubes: capacity exceeded")
    return Mesh(vertices=verts[: nv.value].copy(), faces=tris[: nt.value].copy())


def sdf_grid_from_code(params, cfg: DeepSDFConfig, code: torch.Tensor, resolution: int = 64, extent: float = 1.0,
                       chunk: int = 32768) -> np.ndarray:
    """The SDF on a regular (nz, ny, nx) grid over [-extent, extent]^3,
    decoded on the code's device `chunk` points at a time."""
    lin = jax_linspace(-extent, extent, resolution).to(code.device)
    zz, yy, xx = torch.meshgrid(lin, lin, lin, indexing="ij")
    pts = torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)
    wb = weights(params, cfg)
    out = torch.cat([decode_sdf(params, cfg, code, pts[i:i + chunk], wb) for i in range(0, pts.shape[0], chunk)])
    return out.reshape(resolution, resolution, resolution).cpu().numpy()


def extract_mesh_from_code(params, cfg: DeepSDFConfig, code: torch.Tensor, resolution: int = 64,
                           extent: float = 1.0) -> Mesh:
    """Decode the grid, extract the surface, and rescale the vertices from
    voxel indices to object coordinates in [-extent, extent]^3."""
    mesh = marching_cubes(sdf_grid_from_code(params, cfg, code, resolution, extent), iso=0.0)
    scale = 2.0 * extent / (resolution - 1)
    return Mesh(vertices=(mesh.vertices * scale - extent).astype(np.float32), faces=mesh.faces)
