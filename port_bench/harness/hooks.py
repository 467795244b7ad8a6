"""Spans and captures installed over the program's names for one run.

The benchmark reads the program through a few of its public names: the
facade's `track_*` calls, the shape step (`reconstruct_due_objects`, with
the batched LM `reconstruct_object` inside it), the two hand-written kernels' entries
(`fast_score_nms_pyramid`, `hamming_packed`) with their launch counters,
and where the sensor names one (`harness/sensors/`), the function that
makes the shape step's depth image (`keypoint_depth_image` for stereo).
A hook rebinds a function in every module of the program that imported
it, and never in the module that defines it (whose body updates the
function's own counters), and puts every binding back on exit.
"""

from __future__ import annotations

import sys
import time

import torch

PROGRAM = "qsp_slam_tpu_torch"


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Rebind:
    """Replace `func` by `wrapper` wherever a module of the program holds
    it under its name, except its defining module."""

    def __init__(self, func, wrapper):
        self.func, self.wrapper, self.undo = func, wrapper, []

    def __enter__(self):
        name = self.func.__name__
        for mod_name, mod in list(sys.modules.items()):
            if (mod is None or not mod_name.startswith(PROGRAM + ".") or mod_name == self.func.__module__):
                continue
            if getattr(mod, name, None) is self.func:
                setattr(mod, name, self.wrapper)
                self.undo.append(mod)
        if not self.undo:
            raise RuntimeError(f"no module of {PROGRAM} calls {self.func.__module__}.{name}")
        return self

    def __exit__(self, *exc):
        for mod in self.undo:
            setattr(mod, self.func.__name__, self.func)


class ShapeSteps:
    """The benchmark's own span around each shape step (host clock around
    a synchronise), the step's inputs, the table before and after it, and
    every call of the batched LM inside it (its arguments and results,
    kept as the program made them)."""

    def __init__(self, recon_due, recon_obj):
        self._names = (recon_due, recon_obj)
        # What the hooks call (a planted fault replaces these).
        self.recon_due, self.recon_obj = recon_due, recon_obj
        self.steps, self.frame, self._chunks = [], -1, None
        self.keep = True

    def _recon_obj(self, *args):
        res = self.recon_obj(*args)
        if self._chunks is not None:
            self._chunks.append((args, res))
        return res

    def _recon_due(self, table, inputs, params, dec_cfg, Tcw, opt_cfg):
        sync()
        t0 = time.perf_counter()
        self._chunks = []
        out = self.recon_due(table, inputs, params, dec_cfg, Tcw, opt_cfg)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        chunks, self._chunks = self._chunks, None
        if chunks:
            step = {"frame": self.frame, "ms": ms, "hyps": sum(int(c[0][2].shape[0]) for c in chunks),
                    "opt_cfg": opt_cfg, "dec_cfg": dec_cfg}
            if self.keep:
                step.update(chunks=chunks, inputs=inputs, Tcw=Tcw,
                            before={k: getattr(table, k).clone() for k in ("code", "Tow_shape", "shape_ok")},
                            after={k: getattr(out, k).clone() for k in ("code", "Tow_shape", "shape_ok")})
            self.steps.append(step)
        return out

    def __enter__(self):
        recon_due, recon_obj = self._names
        self._hooks = [Rebind(recon_due, self._recon_due), Rebind(recon_obj, self._recon_obj)]
        for h in self._hooks:
            h.__enter__()
        return self

    def __exit__(self, *exc):
        for h in reversed(self._hooks):
            h.__exit__(*exc)


class KernelCaptures:
    """On the frames named in `frames` (set once the window's frames are
    known), the inputs and outputs of every K1 launch
    (`fast_score_nms_pyramid`) and of up to `k2_calls` K2 launches
    (`hamming_packed`) per frame, kept on the device."""

    def __init__(self, k1, k2, k2_calls: int = 2):
        self.k1, self.k2, self.frames, self.k2_calls = k1, k2, set(), k2_calls
        self.k1_call, self.k2_call = k1, k2  # what the hooks call (a planted fault replaces these)
        self.frame = -1
        self.k1_calls, self.k2_calls_seen = [], []

    def _k1(self, levels, thresholds):
        out = self.k1_call(levels, thresholds)
        if self.frame in self.frames:
            self.k1_calls.append({"frame": self.frame, "levels": list(levels), "thresholds": tuple(thresholds),
                                  "out": out})
        return out

    def _k2(self, a, b):
        out = self.k2_call(a, b)
        if self.frame in self.frames and sum(c["frame"] == self.frame for c in self.k2_calls_seen) < self.k2_calls:
            self.k2_calls_seen.append({"frame": self.frame, "a": a, "b": b, "out": out})
        return out

    def __enter__(self):
        self._hooks = [Rebind(self.k1, self._k1), Rebind(self.k2, self._k2)]
        for h in self._hooks:
            h.__enter__()
        return self

    def __exit__(self, *exc):
        for h in reversed(self._hooks):
            h.__exit__(*exc)


class Capture:
    """The output of `func` (the sensor's shape-step depth image) on each
    frame, kept on the device as the program made it, in `by_frame`."""

    def __init__(self, func):
        self.func, self.frame, self.by_frame = func, -1, {}

    def _capture(self, *args):
        out = self.func(*args)
        self.by_frame[self.frame] = out
        return out

    def __enter__(self):
        self._hook = Rebind(self.func, self._capture).__enter__()
        return self

    def __exit__(self, *exc):
        self._hook.__exit__(*exc)
