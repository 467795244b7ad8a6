"""Learned 2D object detector (counterpart of
`qsp_slam_tpu/perception/detector2d.py`): a CenterNet-style fully
convolutional single-shot head in place of the reference's Mask R-CNN.

One static-shape forward pass (a strided stem, a dilated residual trunk,
1x1 heads for the class heatmap, box size, sub-cell offset and a
foreground logit), peak NMS as a 3x3 max-pool equality and a top-k to a
fixed budget give the replay dict the object step reads (`bbox`,
`label`, `prob`, `valid`, `mask`).  It is trained on the synthetic
renderer's ground truth (`train_detector`); `SlamSystem(detector=(params,
cfg))` then detects at keyframes when a frame comes without detections.

Parameters are a dict of the JAX package's names (`c1_w`, `c1_b`, ...,
`seg_b`) with conv weights in PyTorch's OIHW layout; the npz files keep
the JAX package's HWIO layout and load in either package.  The convs are
cuDNN convolutions (TF32 off, as the package sets it).  XLA's "SAME"
padding of a stride-2 conv on an even input pads (0, 1), not (1, 1), so
`same_conv` pads explicitly.  `jax.lax.top_k` breaks ties by the lower
index; a stable descending sort over the heatmap in (y, x, class) order
gives the same rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device

HEADS = ("hm", "sz", "off", "seg")


class DetectorConfig(NamedTuple):
    num_classes: int = 3
    stride: int = 4  # backbone downsampling factor
    widths: tuple = (16, 32, 48)
    max_det: int = 8
    score_thr: float = 0.3
    input_hw: tuple = (480, 640)


def param_shapes(cfg: DetectorConfig) -> dict:
    """Conv weight shapes in the JAX package's HWIO layout, in its order."""
    w0, w1, w2 = cfg.widths
    return {
        "c1": (3, 3, 1, w0),
        "c2": (3, 3, w0, w1),
        "c3": (3, 3, w1, w2),
        "c4": (3, 3, w2, w2),  # dilation 2
        "c5": (3, 3, w2, w2),  # dilation 4
        "c6": (3, 3, w2, w2),  # dilation 8
        "hm": (1, 1, w2, cfg.num_classes),
        "sz": (1, 1, w2, 2),
        "off": (1, 1, w2, 2),
        "seg": (1, 1, w2, 1),
    }


def he_init(gen: torch.Generator, shapes: dict, num_classes: int, device=None) -> dict:
    """He-normal weights (drawn in HWIO order from `gen`, on the CPU) and
    zero biases; the heatmap bias starts at -4 (the focal loss's prior).
    Conv weights come out OIHW; 2-D (dense) weights stay as drawn."""
    dev = resolve_device(device)
    params = {}
    for name, sh in shapes.items():
        w = torch.randn(sh, generator=gen) * np.sqrt(2.0 / int(np.prod(sh[:-1])))
        params[name + "_w"] = (w.permute(3, 2, 0, 1) if w.dim() == 4 else w).contiguous().to(dev)
        params[name + "_b"] = torch.zeros(sh[-1], device=dev)
    params["hm_b"] = torch.full((num_classes,), -4.0, device=dev)
    return params


def init_detector(gen: torch.Generator, cfg: DetectorConfig, device=None) -> dict:
    """He-initialised conv params: strided stem + dilated trunk + 1x1
    heads (dilations 2/4/8 give a stride-4 cell a whole object's view)."""
    return he_init(gen, param_shapes(cfg), cfg.num_classes, device)


def same_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1, dilation: int = 1):
    """NCHW conv with XLA's "SAME" padding: total (out - 1) * stride +
    effective kernel - in, the odd pixel at the end."""
    pads = []
    for size, k in zip(reversed(x.shape[2:]), reversed(w.shape[2:])):
        ek = (k - 1) * dilation + 1
        total = max((-(-size // stride) - 1) * stride + ek - size, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return F.conv2d(x, w, b, stride=stride, dilation=dilation)


def forward(params: dict, cfg: DetectorConfig, gray: torch.Tensor):
    """gray (H, W) -> (hm (Hs, Ws, C), sz (Hs, Ws, 2), off (Hs, Ws, 2),
    seg (Hs, Ws)) at stride `cfg.stride`, channels last as in the JAX
    package."""
    x = gray[None, None].to(torch.float32) / 255.0 - 0.5
    p = params
    x = F.relu(same_conv(x, p["c1_w"], p["c1_b"], 2))
    x = F.relu(same_conv(x, p["c2_w"], p["c2_b"], 2))
    x = F.relu(same_conv(x, p["c3_w"], p["c3_b"]))
    x = F.relu(same_conv(x, p["c4_w"], p["c4_b"], dilation=2) + x)
    x = F.relu(same_conv(x, p["c5_w"], p["c5_b"], dilation=4) + x)
    x = F.relu(same_conv(x, p["c6_w"], p["c6_b"], dilation=8) + x)
    hm, sz, off, seg = (same_conv(x, p[h + "_w"], p[h + "_b"])[0].permute(1, 2, 0) for h in HEADS)
    return hm, sz, off, seg[..., 0]


def scatter_max_cells(hm_t: torch.Tensor, index: tuple, value: torch.Tensor) -> torch.Tensor:
    """`hm_t.at[index].max(value)`: duplicate cells keep their maximum."""
    flat = torch.zeros((), dtype=torch.int64, device=hm_t.device)
    for i, n in zip(index, hm_t.shape):
        flat = flat * n + i.to(torch.int64)
    return hm_t.reshape(-1).scatter_reduce(0, flat, value, "amax", include_self=True).reshape(hm_t.shape)


def focal_loss(hm: torch.Tensor, hm_t: torch.Tensor) -> torch.Tensor:
    """CenterNet's penalty-reduced focal loss over the heatmap logits."""
    p = torch.clamp(torch.sigmoid(hm), 1e-4, 1.0 - 1e-4)
    pos = hm_t > 0.999
    focal_pos = -((1.0 - p) ** 2) * torch.log(p) * pos
    focal_neg = -((1.0 - hm_t) ** 4) * (p ** 2) * torch.log(1.0 - p) * (~pos)
    n_pos = torch.clamp(torch.sum(pos).to(torch.float32), min=1.0)
    return (torch.sum(focal_pos) + torch.sum(focal_neg)) / n_pos


def _targets(cfg: DetectorConfig, bbox, label, valid, instance):
    """Gaussian-splatted heatmap (a full 1 at each centre cell), size and
    offset at the centres, and the stride-cell foreground target."""
    H, W = cfg.input_hw
    s = cfg.stride
    Hs, Ws = H // s, W // s
    dev = bbox.device
    ys = torch.arange(Hs, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(Ws, dtype=torch.float32, device=dev)[None, :]
    cx = (bbox[:, 0] + bbox[:, 2]) * 0.5 / s
    cy = (bbox[:, 1] + bbox[:, 3]) * 0.5 / s
    bw = torch.clamp((bbox[:, 2] - bbox[:, 0]) / s, min=1e-3)
    bh = torch.clamp((bbox[:, 3] - bbox[:, 1]) / s, min=1e-3)
    sigma = torch.clamp(torch.minimum(bw, bh) / 6.0, min=1.0)
    g = torch.exp(-((xs - cx[:, None, None]) ** 2 + (ys - cy[:, None, None]) ** 2)
                  / (2.0 * sigma[:, None, None] ** 2))
    g = torch.where(valid[:, None, None], g, 0.0)
    onehot = (label[:, None] == torch.arange(cfg.num_classes, device=dev)).to(torch.float32)
    hm_t = torch.amax(g[..., None] * onehot[:, None, None, :], dim=0)
    ix = torch.clamp(torch.floor(cx).to(torch.int32), 0, Ws - 1)
    iy = torch.clamp(torch.floor(cy).to(torch.int32), 0, Hs - 1)
    # The centre cell is a full positive (the focal loss's positives are
    # hm_t == 1; a gaussian never reaches 1 on the grid).
    hm_t = scatter_max_cells(hm_t, (iy, ix, label), valid.to(torch.float32))
    sz_t = torch.stack([torch.log(bw), torch.log(bh)], -1)
    off_t = torch.stack([cx - ix, cy - iy], -1)
    seg_t = torch.mean((instance >= 0).to(torch.float32).reshape(Hs, s, Ws, s), dim=(1, 3)) > 0.5
    return hm_t, (iy, ix, sz_t, off_t), seg_t


def detector_loss(params, cfg: DetectorConfig, gray, bbox, label, valid, instance) -> torch.Tensor:
    """Focal heatmap loss + L1 size and offset at the centres (full
    weight) + the foreground logit's binary cross-entropy."""
    hm, sz, off, seg = forward(params, cfg, gray)
    hm_t, (iy, ix, sz_t, off_t), seg_t = _targets(cfg, bbox, label, valid, instance)
    w = valid.to(torch.float32)
    nw = torch.clamp(w.sum(), min=1.0)
    iy, ix = iy.long(), ix.long()
    l_sz = torch.sum(torch.abs(sz[iy, ix] - sz_t).sum(-1) * w) / nw
    l_off = torch.sum(torch.abs(off[iy, ix] - off_t).sum(-1) * w) / nw
    st = seg_t.to(torch.float32)
    l_seg = torch.mean(torch.clamp(seg, min=0) - seg * st + torch.log1p(torch.exp(-torch.abs(seg))))
    return focal_loss(hm, hm_t) + l_sz + l_off + l_seg


def peak_topk(hm: torch.Tensor, k: int):
    """3x3 peak NMS of sigmoid(hm) (Hs, Ws, C) and the top `k` scores with
    their (y, x, class) cells, ties to the lower flat index as
    `jax.lax.top_k` breaks them."""
    p = torch.sigmoid(hm)
    pc = p.permute(2, 0, 1)[None]
    keep = pc == F.max_pool2d(pc, 3, stride=1, padding=1)
    p = torch.where(keep, pc, 0.0)[0].permute(1, 2, 0)
    Hs, Ws, C = p.shape
    scores, flat = torch.sort(p.reshape(-1), descending=True, stable=True)
    scores, flat = scores[:k], flat[:k]
    cell = flat // C
    return scores, (flat % C).to(torch.int32), cell // Ws, cell % Ws


def detect_objects(params: dict, cfg: DetectorConfig, gray: torch.Tensor) -> dict:
    """One frame -> {bbox, label, prob, valid, mask} (the replay dict), on
    the frame's device.  `gray` may be any integer multiple `ds` of
    `cfg.input_hw`: it is mean-pooled down, and boxes and masks are scaled
    back to the frame."""
    Hg, Wg = gray.shape
    H, W = cfg.input_hw
    ds = Hg // H
    if ds * H != Hg or ds * W != Wg:
        raise ValueError(f"frame {tuple(gray.shape)} not a multiple of {cfg.input_hw}")
    if ds > 1:
        gray = torch.mean(gray.to(torch.float32).reshape(H, ds, W, ds), dim=(1, 3))
    s = cfg.stride
    hm, sz, off, seg = forward(params, cfg, gray)
    scores, cls, iy, ix = peak_topk(hm, cfg.max_det)
    o = off[iy, ix]
    wh = torch.exp(sz[iy, ix]) * s
    cx = (ix.to(torch.float32) + o[:, 0]) * s
    cy = (iy.to(torch.float32) + o[:, 1]) * s
    bbox = torch.stack([
        torch.clamp(cx - wh[:, 0] / 2, 0, W - 1),
        torch.clamp(cy - wh[:, 1] / 2, 0, H - 1),
        torch.clamp(cx + wh[:, 0] / 2, 0, W - 1),
        torch.clamp(cy + wh[:, 1] / 2, 0, H - 1),
    ], -1) * ds
    valid = scores > cfg.score_thr
    # Nearest upsampling at the integer factor s * ds: pixel i reads cell
    # i // (s * ds), as jax.image.resize's "nearest" does.
    fg = F.interpolate(torch.sigmoid(seg)[None, None], size=(Hg, Wg), mode="nearest")[0, 0] > 0.5
    yy = torch.arange(Hg, dtype=torch.float32, device=gray.device)[:, None]
    xx = torch.arange(Wg, dtype=torch.float32, device=gray.device)[None, :]
    b = bbox[:, None, None, :]
    inside = (xx >= b[..., 0]) & (xx <= b[..., 2]) & (yy >= b[..., 1]) & (yy <= b[..., 3])
    return {"bbox": bbox, "label": cls, "prob": torch.where(valid, scores, 0.0), "valid": valid,
            "mask": inside & fg[None]}


# ---------------------------------------------------------------------------
# Weights on disk: the JAX package's npz (HWIO conv weights, `__cfg__`)
# ---------------------------------------------------------------------------

def params_to_numpy(params: dict) -> dict:
    """Port params -> numpy arrays in the JAX package's layout (HWIO)."""
    return {k: (v.detach().permute(2, 3, 1, 0) if v.dim() == 4 else v.detach()).cpu().numpy()
            for k, v in params.items()}


def params_from_numpy(arrays, device=None) -> dict:
    """numpy arrays in the JAX package's layout (HWIO conv weights, dense
    weights as they are) -> port params (OIHW), f32 on `device`."""
    dev = resolve_device(device)
    out = {}
    for k, v in arrays.items():
        t = torch.tensor(np.asarray(v), dtype=torch.float32)
        out[k] = (t.permute(3, 2, 0, 1) if t.dim() == 4 else t).contiguous().to(dev)
    return out


def save_detector2d(path: str, params: dict, cfg: DetectorConfig) -> None:
    np.savez(
        path,
        __cfg__=np.asarray([cfg.num_classes, cfg.stride, *cfg.widths, cfg.max_det, cfg.score_thr,
                            *cfg.input_hw], np.float64),
        **params_to_numpy(params),
    )


def load_detector2d(path: str, device=None):
    """-> (params on `device`, DetectorConfig)."""
    with np.load(path) as z:
        c = z["__cfg__"]
        cfg = DetectorConfig(num_classes=int(c[0]), stride=int(c[1]), widths=(int(c[2]), int(c[3]), int(c[4])),
                             max_det=int(c[5]), score_thr=float(c[6]), input_hw=(int(c[7]), int(c[8])))
        params = params_from_numpy({k: z[k] for k in z.files if k != "__cfg__"}, device)
    return params, cfg


# ---------------------------------------------------------------------------
# Training on the synthetic renderer's ground truth
# ---------------------------------------------------------------------------

def cosine_lr(lr: float, steps: int, alpha: float = 0.1):
    """`optax.cosine_decay_schedule(lr, steps, alpha)` as a `LambdaLR`
    factor of the update count t (the first update uses `lr`)."""
    def factor(t: int) -> float:
        t = min(t, steps)
        return (1.0 - alpha) * 0.5 * (1.0 + np.cos(np.pi * t / steps)) + alpha
    return factor


def adam(params: dict, lr: float, steps: int):
    """torch Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8 added to
    sqrt(v_hat)) under the cosine schedule; the params become leaves."""
    leaves = [t.requires_grad_() for t in params.values()]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, cosine_lr(lr, steps))


def training_poses(seed: int, scenes: list, steps: int, num_objects: int):
    """The JAX package's pose schedule for `steps` updates, from numpy's
    generator seeded with `seed`: three in four poses look at a random
    object from above (guaranteed positives), the rest sit on an orbit
    sweep.  Scenes rotate every 4 steps.  Yields (scene, T_cw (4, 4))."""
    from ..data.render import orbit_trajectory
    from ..data.synthetic import _lookat

    rng = np.random.default_rng(seed)
    for i in range(steps):
        scene = scenes[(i // 4) % len(scenes)]
        if rng.random() < 0.75:
            c = scene.ellipsoids[int(rng.integers(num_objects)), :3].cpu().numpy().astype(np.float64)
            off = np.array([rng.uniform(-2.0, 2.0), rng.uniform(-1.8, -0.4), rng.uniform(-4.8, -1.2)])
            T_cw = _lookat(c + off, c + rng.normal(0, 0.15, 3)).astype(np.float32)
        else:
            traj = orbit_trajectory(64, step=0.03, pitch=float(rng.uniform(0.25, 0.45)))
            T_cw = traj[int(rng.integers(0, 64))]
        yield scene, T_cw


def train_step(params, opt, sched, cfg: DetectorConfig, scene, T_cw, intr) -> torch.Tensor:
    """One update on one rendered view and its ground truth -> the loss
    (a device scalar)."""
    from ..data.render import gt_detections, render_scene

    H, W = cfg.input_hw
    with torch.no_grad():
        gray, _, inst = render_scene(scene, T_cw, intr, height=H, width=W)
        det = gt_detections(scene, T_cw, intr, width=W, height=H)
    loss = detector_loss(params, cfg, gray, det["bbox"], det["label"], det["valid"], inst)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def train_detector(seed: int, cfg: DetectorConfig = DetectorConfig(), steps: int = 600, num_objects: int = 4,
                   scenes: int = 6, lr: float = 1e-3, intr=None, device=None, params: dict | None = None):
    """Train on the renderer's ground truth: Adam under the cosine
    schedule, one rendered view per update.  `seed` seeds the init's
    generator and the pose schedule (the JAX package draws its schedule's
    seed from its key: pass that integer, and its init through `params`,
    to follow its run).  `intr` must match `cfg.input_hw` (default: the
    TUM intrinsics at 480x640).  -> (params, losses (list of floats))."""
    from ..data.render import make_scene
    from ..slam.tracking import TrackingConfig

    dev = resolve_device(device)
    if intr is None:
        intr = TrackingConfig().intr
    if params is None:
        params = init_detector(torch.Generator().manual_seed(seed), cfg, dev)
    params = {k: v.detach().clone().to(dev) for k, v in params.items()}
    opt, sched = adam(params, lr, steps)
    scene_list = [make_scene(num_objects=num_objects, seed=100 + i, device=dev) for i in range(scenes)]
    losses = [train_step(params, opt, sched, cfg, scene, T_cw, intr)
              for scene, T_cw in training_poses(seed, scene_list, steps, num_objects)]
    params = {k: v.detach() for k, v in params.items()}
    return params, torch.stack(losses).cpu().tolist() if losses else []
