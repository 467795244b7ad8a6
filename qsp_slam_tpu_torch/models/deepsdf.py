"""DeepSDF decoder: a latent-code-conditioned signed-distance MLP
(counterpart of `qsp_slam_tpu/models/deepsdf.py`).

Eight weight-normalised linear layers (W = g v / |v| per output row),
ReLU between them, the (code, xyz) input concatenated again at the
`latent_in` layers, tanh on the output.  Parameters are a plain dict
`{"lin{i}": {"v", "g", "b"}}`, the JAX package's pytree, so the
functional `decode_sdf` batches over hypotheses and traces under
`torch.func`; `DeepSDFDecoder` holds the same tensors as an `nn.Module`
whose `state_dict()` uses the reference checkpoints' keys
(`lin{i}.weight_v`, `lin{i}.weight_g` of shape (out, 1), `lin{i}.bias`),
so one checkpoint loads into both packages.

Everything runs in full f32: the reference pins the highest matmul
precision, and the package turns TF32 off.  `train_toy_decoder` fits the
decoder to an analytic ellipsoid family, the stand-in for pretrained
weights.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .. import resolve_device


class DeepSDFConfig(NamedTuple):
    code_dim: int = 64
    hidden: int = 512
    num_layers: int = 8  # linear layers, the output layer included
    latent_in: tuple = (4,)  # layers whose input re-concatenates (code, xyz)

    @property
    def in_dim(self) -> int:
        return self.code_dim + 3


def _layer_dims(cfg: DeepSDFConfig) -> list[tuple[int, int]]:
    """(in, out) per layer.  A layer feeding a `latent_in` layer narrows
    its output so the concatenation keeps width `hidden`."""
    dims = []
    for i in range(cfg.num_layers):
        din = cfg.in_dim if i == 0 else cfg.hidden
        dout = 1 if i == cfg.num_layers - 1 else cfg.hidden
        if (i + 1) in cfg.latent_in:
            dout = cfg.hidden - cfg.in_dim
        dims.append((din, dout))
    return dims


def init_decoder(gen: torch.Generator | None, cfg: DeepSDFConfig, device=None) -> dict:
    """He-normal directions v, g = |v| per row, zero biases, drawn from
    `gen` on its device (moved to `device`)."""
    dev = resolve_device(device)
    gdev = gen.device if gen is not None else None
    params = {}
    for i, (din, dout) in enumerate(_layer_dims(cfg)):
        v = (torch.randn((dout, din), generator=gen, device=gdev) * (2.0 / din) ** 0.5).to(dev)
        params[f"lin{i}"] = {"v": v, "g": torch.linalg.vector_norm(v, dim=1),
                             "b": torch.zeros(dout, device=dev)}
    return params


def weights(params: dict, cfg: DeepSDFConfig) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(W, b) per layer, W = v * g / max(|v|, 1e-12) row-wise."""
    out = []
    for i in range(cfg.num_layers):
        p = params[f"lin{i}"]
        v = p["v"]
        W = v * (p["g"] / torch.clamp(torch.linalg.vector_norm(v, dim=1), min=1e-12))[:, None]
        out.append((W, p["b"]))
    return out


def decode_sdf(params: dict, cfg: DeepSDFConfig, code: torch.Tensor, xyz: torch.Tensor,
               wb: list | None = None) -> torch.Tensor:
    """SDF at points: code (C,) with xyz (..., 3), or a hypothesis batch
    code (B, C) with xyz (B, ..., 3) -> (...) / (B, ...).  `wb` takes the
    layers' (W, b) when a caller has built them already; otherwise they are
    built once here."""
    wb = weights(params, cfg) if wb is None else wb
    if code.dim() == 2:
        code = code.reshape(code.shape[:1] + (1,) * (xyz.dim() - 2) + code.shape[1:])
    inp = torch.cat([code.expand(xyz.shape[:-1] + (cfg.code_dim,)), xyz], dim=-1)
    x = inp
    for i, (W, b) in enumerate(wb):
        if i in cfg.latent_in and i > 0:
            x = torch.cat([x, inp], dim=-1)
        x = x @ W.T + b
        if i < cfg.num_layers - 1:
            x = torch.relu(x)
    return torch.tanh(x[..., 0])


def macs_per_point(cfg: DeepSDFConfig) -> int:
    """Multiply-adds of one decoder evaluation."""
    return sum(din * dout for din, dout in _layer_dims(cfg))


class _WNLinear(nn.Module):
    def __init__(self, v: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(g.reshape(-1, 1))
        self.bias = nn.Parameter(b)


class DeepSDFDecoder(nn.Module):
    """The decoder as a module: `state_dict()` has the reference's keys,
    `params()` gives the functional dict (views of the same tensors)."""

    def __init__(self, cfg: DeepSDFConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            p = params[f"lin{i}"]
            setattr(self, f"lin{i}", _WNLinear(p["v"], p["g"], p["b"]))

    def params(self) -> dict:
        return {f"lin{i}": {"v": getattr(self, f"lin{i}").weight_v, "g": getattr(self, f"lin{i}").weight_g[:, 0],
                            "b": getattr(self, f"lin{i}").bias} for i in range(self.cfg.num_layers)}

    def forward(self, code: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
        return decode_sdf(self.params(), self.cfg, code, xyz)


# ---------------------------------------------------------------------------
# Checkpoints of the reference (`ModelParameters/latest.pth`)
# ---------------------------------------------------------------------------


def params_from_state_dict(sd: dict, cfg: DeepSDFConfig, device=None) -> dict:
    """A weight-normalised state dict (bare, `module.` or `decoder.` keys)
    -> params."""
    dev = resolve_device(device)

    def get(i, k):
        for prefix in ("", "module.", "decoder."):
            if f"{prefix}lin{i}.{k}" in sd:
                return torch.as_tensor(sd[f"{prefix}lin{i}.{k}"], dtype=torch.float32).to(dev)
        raise KeyError(f"lin{i}.{k} not in checkpoint")

    return {f"lin{i}": {"v": get(i, "weight_v"), "g": get(i, "weight_g").reshape(-1), "b": get(i, "bias")}
            for i in range(cfg.num_layers)}


def load_torch_checkpoint(path: str, cfg: DeepSDFConfig, device=None) -> dict:
    """Load a reference-format checkpoint (`{"model_state_dict": {...}}`,
    or the state dict alone) into params."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_state_dict(state.get("model_state_dict", state), cfg, device)


# ---------------------------------------------------------------------------
# The toy shape family (the stand-in for pretrained priors)
# ---------------------------------------------------------------------------


def ellipsoid_sdf(xyz: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """Approximate SDF of an axis-aligned ellipsoid with half-axes `half`."""
    k0 = torch.linalg.vector_norm(xyz / half, dim=-1)
    k1 = torch.linalg.vector_norm(xyz / (half * half), dim=-1)
    return k0 * (k0 - 1.0) / torch.clamp(k1, min=1e-9)


def train_toy_decoder(seed: int, cfg: DeepSDFConfig, num_shapes: int = 12, steps: int = 600,
                      batch: int = 512, lr: float = 1e-3, device=None):
    """Auto-decoder training on an analytic ellipsoid family inside the
    unit sphere: Adam on the decoder and one code per shape, loss the mean
    squared error against the SDF clipped to +-0.3 plus 1e-4 of the mean
    squared code norm.  Draws come from a generator on the device seeded
    with `seed` (not the reference's `jax.random` stream).
    -> (params, codes (num_shapes, code_dim), halves (num_shapes, 3))."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    halves = 0.25 + 0.4 * torch.rand((num_shapes, 3), generator=gen, device=dev)
    codes = (0.01 * torch.randn((num_shapes, cfg.code_dim), generator=gen, device=dev)).requires_grad_()
    params = init_decoder(gen, cfg, dev)
    leaves = [t.requires_grad_() for p in params.values() for t in p.values()]
    opt = torch.optim.Adam(leaves + [codes], lr=lr)
    for _ in range(steps):
        sid = torch.randint(0, num_shapes, (batch,), generator=gen, device=dev)
        xyz = 2.0 * torch.rand((batch, 3), generator=gen, device=dev) - 1.0
        gt = torch.clamp(ellipsoid_sdf(xyz, halves[sid]), -0.3, 0.3)
        pred = decode_sdf(params, cfg, codes[sid], xyz[:, None, :])[:, 0]
        loss = torch.mean((pred - gt) ** 2) + 1e-4 * torch.mean(torch.sum(codes * codes, dim=-1))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    detach = {k: {n: t.detach() for n, t in p.items()} for k, p in params.items()}
    return detach, codes.detach(), halves
