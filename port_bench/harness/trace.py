"""Reduction of a `torch.profiler` trace of one shape period to what the
per-layer readers and the result line need: device busy time (the union
of every device operation's interval), kernel launches, each program
kernel's launches and device time, the device operations that took most
time, and the longest idle gaps labelled by what the host was doing.
"""

from __future__ import annotations

import re

from torch.autograd import DeviceType

KERNELS = {"k1": "fast_score_nms_pyramid_kernel", "k2": "hamming_mma_kernel"}  # as the profiler names them


def _label(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.\-/]", "_", name)[:64]


def reduce(prof) -> dict:
    """`prof` a stopped profiler whose frames ran inside `frame_<i>`
    annotations; the traced window runs from the first frame's start to
    the last one's end, and device operations outside it are clipped
    away."""
    dev, host, frames = [], [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or e.name().startswith("frame_")):  # the frames' spans mirrored
                dev.append((s, s + d, e.name()))
        elif e.name().startswith("frame_"):
            frames.append((s, s + d, e.name()))
        else:
            host.append((s, s + d, e.name()))
    frames.sort()
    if not dev or not frames:
        raise RuntimeError("the trace holds no device operation or no frame span")
    lo, hi = frames[0][0], max(e for _, e, _ in frames)
    dev = sorted((max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi)
    busy, gaps, cur_s, cur_e = 0, [], None, lo
    for s, e, _ in dev:
        if s > cur_e:
            gaps.append((cur_e, s))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s = s
        elif cur_s is None:
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - (cur_s if cur_s is not None else cur_e)
    if hi > cur_e:
        gaps.append((cur_e, hi))

    by_name, kernels, launches = {}, {k: {"launches": 0, "device_s": 0.0} for k in KERNELS}, 0
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        if not (n.startswith("Memcpy") or n.startswith("Memset")):
            launches += 1
        for k, kname in KERNELS.items():
            if kname in n:
                kernels[k]["launches"] += 1
                kernels[k]["device_s"] += (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    host.sort()
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]

    def what(t: int) -> str:
        frame = next((n for s, e, n in frames if s <= t < e), "between_frames")
        inner = [(s, n) for s, e, n in host if s <= t < e]
        return f"{frame}_/_{max(inner)[1] if inner else 'no_host_operation'}"

    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "launches": launches, "kernels": kernels,
            "device_ops": [[_label(n), v] for n, v in top],
            "idle_gaps": [[_label(what(s)), (e - s) / 1e9] for s, e in longest]}
