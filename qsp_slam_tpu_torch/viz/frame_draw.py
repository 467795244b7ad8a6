"""Headless frame drawer: annotated per-frame PNGs (counterpart of
`qsp_slam_tpu/viz/frame_draw.py`).

Tracked keypoints in green, untracked in gray, detection boxes in their
label's colour with `label:prob`, and a black status bar (frame, state,
keyframes, points, objects, loops).  The frame is drawn into an (H, W, 3)
uint8 numpy array and written by the package's standard-library PNG
encoder, so no imaging package is needed.  The rectangles follow
`PIL.ImageDraw.rectangle`'s pixel rules (corners truncated toward zero,
an outline of width w drawn inwards), so the keypoint squares, the box
outlines and the status bar are the pixels the JAX package's PIL drawing
gives.  Text uses the 5x7 bitmap font below, at the reference's anchor
points; its glyphs are not PIL's default font, which changes between
Pillow versions.
"""

from __future__ import annotations

import os

import numpy as np

from ..data.make_tum import png_encode

# Label palette (RGB), cycled for labels beyond the table.
_COLORS = [
    (66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
    (171, 71, 188), (0, 172, 193),
]

# 5x7 glyphs: five column bytes each, bit 0 the top row.  Characters not
# in the table draw as a hollow box.
_FONT = {
    " ": "0000000000", "!": "00005f0000", '"': "0007000700", "#": "147f147f14", "%": "2313086462",
    "'": "0005030000", "(": "001c224100", ")": "0041221c00", "*": "082a1c2a08", "+": "08083e0808",
    ",": "0050300000", "-": "0808080808", ".": "0060600000", "/": "2010080402", "0": "3e5149453e",
    "1": "00427f4000", "2": "4261514946", "3": "2141454b31", "4": "1814127f10", "5": "2745454539",
    "6": "3c4a494930", "7": "0171090503", "8": "3649494936", "9": "064949291e", ":": "0036360000",
    ";": "0056360000", "<": "0814224100", "=": "1414141414", ">": "0041221408", "?": "0201510906",
    "A": "7e1111117e", "B": "7f49494936", "C": "3e41414122", "D": "7f4141221c", "E": "7f49494941",
    "F": "7f09090901", "G": "3e4149497a", "H": "7f0808087f", "I": "00417f4100", "J": "2040413f01",
    "K": "7f08142241", "L": "7f40404040", "M": "7f020c027f", "N": "7f0408107f", "O": "3e4141413e",
    "P": "7f09090906", "Q": "3e4151215e", "R": "7f09192946", "S": "4649494931", "T": "01017f0101",
    "U": "3f4040403f", "V": "1f2040201f", "W": "3f4038403f", "X": "6314081463", "Y": "0708700807",
    "Z": "6151494543", "[": "007f414100", "]": "0041417f00", "_": "4040404040", "a": "2054545478",
    "b": "7f48444438", "c": "3844444420", "d": "384444487f", "e": "3854545418", "f": "087e090102",
    "g": "0c5252523e", "h": "7f08040478", "i": "00447d4000", "j": "2040443d00", "k": "7f10284400",
    "l": "00417f4000", "m": "7c04180478", "n": "7c08040478", "o": "3844444438", "p": "7c14141408",
    "q": "081414187c", "r": "7c08040408", "s": "4854545420", "t": "043f444020", "u": "3c4040207c",
    "v": "1c2040201c", "w": "3c4030403c", "x": "4428102844", "y": "0c5050503c", "z": "4464544c44",
    "|": "00007f0000",
}
_BOX = "7f4141417f"
GLYPH_W, GLYPH_H, ADVANCE = 5, 7, 6


def _glyph(ch: str) -> np.ndarray:
    cols = bytes.fromhex(_FONT.get(ch, _BOX))
    return np.array([[(c >> r) & 1 for c in cols] for r in range(GLYPH_H)], bool)


def text_box(xy, text: str) -> tuple[int, int, int, int]:
    """The pixels `draw_text` may touch: (x0, y0, x1, y1), inclusive."""
    x, y = int(xy[0]), int(xy[1])
    return x, y, x + ADVANCE * len(text) - 2, y + GLYPH_H - 1


def draw_text(img: np.ndarray, xy, text: str, color) -> None:
    """Write `text` with its first glyph's top-left pixel at xy (truncated
    toward zero), clipped to the image."""
    H, W = img.shape[:2]
    x, y = int(xy[0]), int(xy[1])
    for i, ch in enumerate(text):
        g = _glyph(ch)
        x0 = x + ADVANCE * i
        ys, xs = np.nonzero(g)
        ys, xs = ys + y, xs + x0
        ok = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        img[ys[ok], xs[ok]] = color


def _hline(img, x0: int, y: int, x1: int, color) -> None:
    H, W = img.shape[:2]
    if 0 <= y < H:
        a, b = max(x0, 0), min(x1, W - 1)
        if a <= b:
            img[y, a:b + 1] = color


def _vline(img, x: int, ya: int, yb: int, color) -> None:
    """A vertical line from ya toward yb without yb itself (nothing when
    they are equal), as PIL's line primitive steps."""
    H, W = img.shape[:2]
    if not 0 <= x < W or ya == yb:
        return
    lo, hi = (ya, yb - 1) if ya < yb else (yb + 1, ya)
    lo, hi = max(lo, 0), min(hi, H - 1)
    if lo <= hi:
        img[lo:hi + 1, x] = color


def draw_rectangle(img: np.ndarray, xy, color, width: int = 1, fill: bool = False) -> None:
    """`PIL.ImageDraw.rectangle(xy, outline=color, width=width)` (or
    `fill=color`) on an (H, W, 3) array: the corners are truncated toward
    zero and the outline's `width` rows and columns lie inside the box."""
    if xy[2] < xy[0]:
        raise ValueError("x1 must be greater than or equal to x0")
    if xy[3] < xy[1]:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = (int(v) for v in xy)
    if fill:
        for y in range(max(y0, 0), min(y1, img.shape[0]) + 1):
            _hline(img, x0, y, x1, color)
        return
    for i in range(max(width, 1)):
        _hline(img, x0, y0 + i, x1, color)
        _hline(img, x0, y1 - i, x1, color)
        _vline(img, x1 - i, y0 + width, y1 - width + 1, color)
        _vline(img, x0 + i, y0 + width, y1 - width + 1, color)


def annotate_frame(
    gray,
    kp_xy=None,
    kp_tracked=None,
    bboxes=None,
    labels=None,
    probs=None,
    bbox_valid=None,
    status: str = "",
) -> np.ndarray:
    """Compose an annotated RGB frame; returns the (H, W, 3) uint8 array
    (the JAX package returns a `PIL.Image` of the same pixels outside the
    text)."""
    g = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    img = np.stack([g, g, g], -1)

    if kp_xy is not None:
        kp_xy = np.asarray(kp_xy)
        tracked = np.asarray(kp_tracked) if kp_tracked is not None else np.zeros(len(kp_xy), bool)
        for (x, y), t in zip(kp_xy, tracked):
            if x <= 0 and y <= 0:
                continue  # padding slot
            color = (0, 230, 80) if t else (150, 150, 150)
            r = 2 if t else 1
            draw_rectangle(img, [x - r, y - r, x + r, y + r], color)

    if bboxes is not None:
        bboxes = np.asarray(bboxes)
        n = len(bboxes)
        valid = np.asarray(bbox_valid) if bbox_valid is not None else np.ones(n, bool)
        labels = np.asarray(labels) if labels is not None else np.zeros(n, int)
        probs = np.asarray(probs) if probs is not None else np.ones(n)
        for b, lab, p, v in zip(bboxes, labels, probs, valid):
            if not v:
                continue
            c = _COLORS[int(lab) % len(_COLORS)]
            draw_rectangle(img, [b[0], b[1], b[2], b[3]], c, width=2)
            draw_text(img, (b[0] + 2, max(b[1] - 11, 0)), f"{int(lab)}:{p:.2f}", c)

    if status:
        H, W = img.shape[:2]
        draw_rectangle(img, [0, H - 14, W, H], (0, 0, 0), fill=True)
        draw_text(img, (4, H - 13), status, (255, 255, 255))
    return img


def save_annotated(path: str, *args, **kwargs) -> None:
    """`annotate_frame` written as a PNG at `path` (directories made)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_encode(annotate_frame(*args, **kwargs)))


def frame_status(system, frame_idx: int) -> str:
    """One-line tracker status (the status bar's text)."""
    return (
        f"f{frame_idx} {'OK' if system.initialized else 'INIT'} "
        f"kfs={system.stats['keyframes']} pts={int(system.map_state.num_pts)} "
        f"objs={int(system.objects.valid.sum())} loops={system.loops_closed}"
    )
