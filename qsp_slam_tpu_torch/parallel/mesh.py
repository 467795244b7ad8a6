"""The 1-D rank mesh of the sharded BA modules (counterpart of
`qsp_slam_tpu/parallel/mesh.py`).

The reference is one controller driving a `jax.sharding.Mesh` of devices.
Here each mesh position is one process (SPMD on `torch.distributed`):
rank r holds block r of the sharded axis and runs on `cuda:(r %
device_count)`, or on the CPU.

Backend rule (one rule, no fallback): NCCL when every rank has a card of
its own (CUDA and world size <= device count); gloo when ranks share a
card or run on the CPU.  NCCL refuses two ranks on one card, so N > 1
ranks on one GPU run gloo over CUDA tensors: the math stays on the card,
and the collectives stage their buffers through the host.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist


def choose_backend(world_size: int, device_type: str) -> str:
    """The process-group backend for `world_size` ranks on `device_type`."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, cpu: bool = False) -> torch.device:
    """Rank r's device: `cuda:(r % device_count)`, or the CPU when asked;
    raises without CUDA unless asked for the CPU."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass cpu=True to run the ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclass(frozen=True)
class Mesh:
    """One axis of `size` ranks; `rank` is this process's place on it and
    `group` its process group (None for a size-1 mesh)."""

    axis: str
    size: int
    rank: int
    backend: str | None
    device: torch.device
    group: Any = None

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis,)

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


def make_mesh(num_devices: int | None = None, axis: str = "devices", device=None) -> Mesh:
    """1-D mesh over every rank of the default group (`num_devices` None or
    the group's size; a group of one rank too), or over this rank alone
    without a group (`num_devices` 1 in a larger group, or no group).  Any
    other size raises, as the reference's fails when fewer devices are
    visible.  `device` defaults to the rank's card (`rank_device`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if num_devices is None else int(num_devices)
    if n not in (1, world):
        raise ValueError(f"make_mesh: {n} ranks asked for, the process group has {world}"
                         + ("" if dist.is_initialized() else " (no process group is initialized)"))
    me = dist.get_rank() if dist.is_initialized() else 0
    dev = torch.device(device) if device is not None else rank_device(me)
    if n < world or not dist.is_initialized():
        return Mesh(axis, 1, 0, None, dev)
    return Mesh(axis, n, me, dist.get_backend(), dev, dist.group.WORLD)


# -- collectives over a mesh -----------------------------------------------
# A size-1 mesh without a group makes each an identity.  gloo runs on host
# buffers: a CUDA tensor crosses to the host and back around the call.


def _wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.cpu() if mesh.backend == "gloo" and x.is_cuda else x


def all_reduce(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum of `x` over the mesh (every rank gets the same bits)."""
    if mesh.group is None:
        return x
    w = _wire(mesh, x)
    dist.all_reduce(w, group=mesh.group)
    return w.to(x.device)


def all_reduce_flat(mesh: Mesh, xs) -> list:
    """Sums of the tensors `xs` over the mesh as one collective (one flat
    buffer), split back into their shapes."""
    flat = all_reduce(mesh, torch.cat([x.reshape(-1) for x in xs]))
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].reshape(x.shape))
        at += x.numel()
    return out


def broadcast(mesh: Mesh, xs):
    """Rank 0's tensors `xs` (a tuple or NamedTuple) on every rank."""
    if mesh.group is None:
        return xs
    out = []
    for x in xs:
        w = _wire(mesh, x)
        w = w.clone() if w is x else w  # the caller's tensors stay as given
        dist.broadcast(w, src=0, group=mesh.group)
        out.append(w.to(x.device, x.dtype))
    return type(xs)(*out) if hasattr(xs, "_fields") else type(xs)(out)


def all_gather_blocks(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's block `x` concatenated in rank order on every rank."""
    if mesh.group is None:
        return x
    w = _wire(mesh, x)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    return torch.cat(parts).to(x.device, x.dtype)


def local_block(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous block of an axis of length `n` (a multiple of
    the mesh size), in the order of the reference's device blocks."""
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def tree_to(x, device):
    """`x` with every tensor in its tuples, NamedTuples, lists and dicts
    moved to `device` (other leaves as they are)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_to(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: tree_to(v, device) for k, v in x.items()}
    return x


def broadcast_object(mesh: Mesh, obj, device):
    """Rank 0's picklable `obj` on every rank, its tensors on `device`
    (rank 0 keeps its own)."""
    if mesh.group is None:
        return obj
    box = [tree_to(obj, "cpu") if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return obj if mesh.rank == 0 else tree_to(box[0], device)


def tree_digest(x) -> str:
    """SHA-256 of the bytes of every tensor in `x` (as `tree_to` walks it),
    in order: equal digests on two ranks mean bitwise equal states."""
    h = hashlib.sha256()

    def walk(v):
        if isinstance(v, torch.Tensor):
            h.update(v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(v, (tuple, list)):
            for u in v:
                walk(u)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u)

    walk(x)
    return h.hexdigest()
