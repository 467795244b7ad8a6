"""Faults planted under the timed path, for the tests that show the
comparison catches them (and for their readings on the card): each
replaces a call that the benchmark's hooks make into the program.

  lm_unchanged   the shape step's LM returns every hypothesis as it started
  half_batch     the LM optimises the first half of each batch of
                 hypotheses and returns the rest as they started
  fewer_trips    the LM runs half its trips (at least one)
  code_altered   the LM's codes come back shifted by 0.01
  start_altered  the LM's hypotheses start from frames moved by 1 cm
  inputs_altered the shape step's observed depths come to the LM 0.1% long
  ellipsoid_altered the object table leaves the shape step (the object
                 step's last stage) with every centre moved 0.2 m along
                 the map's x and every half-axis 30% long
  k1_altered     K1's first score map has one score changed
  k2_altered     K2's distance matrix has one entry changed
"""

from __future__ import annotations

import torch


def _no_trips(recon, args):
    return recon(*args[:-1], args[-1]._replace(iters=0))


def _fewer_trips(recon):
    def run(*a):
        return recon(*a[:-1], a[-1]._replace(iters=max(1, a[-1].iters // 2)))
    return run


def _half(recon):
    def run(*a):
        h = max(1, a[2].shape[0] // 2)
        first = recon(*a[:2], *(x[:h] for x in a[2:9]), a[9])
        if h == a[2].shape[0]:
            return first
        rest = _no_trips(recon, (*a[:2], *(x[h:] for x in a[2:9]), a[9]))
        return type(first)(*(torch.cat([p, q]) for p, q in zip(first, rest)))
    return run


def _shifted(recon):
    def run(*a):
        res = recon(*a)
        return res._replace(code=res.code + 0.01)
    return run


def _k1_bad(k1):
    def run(levels, thresholds):
        out = k1(levels, thresholds)
        out[0][0].view(-1)[out[0][0].numel() // 2] += 1.0
        return out
    return run


def _k2_bad(k2):
    def run(a, b):
        out = k2(a, b)
        out.view(-1)[0] += 1
        return out
    return run


def _start_moved(recon_due):
    def run(table, inputs, *a):
        T = inputs.T_oc_init.clone()
        T[..., :3, 3] += 0.01
        return recon_due(table, inputs._replace(T_oc_init=T), *a)
    return run


def _depths_scaled(recon_due):
    def run(table, inputs, *a):
        return recon_due(table, inputs._replace(depth_obs=inputs.depth_obs * 1.001), *a)
    return run


def _axes_long(recon_due):
    def run(*a):
        out = recon_due(*a)
        e = out.ellipsoid.clone()
        e[:, 0] += 0.2
        e[:, 6:9] *= 1.3
        return out._replace(ellipsoid=e)
    return run


def make(name: str):
    """-> plant(shape, kernels): puts the fault beneath the hooks' calls."""
    def plant(shape, kern):
        if name == "lm_unchanged":
            recon = shape.recon_obj
            shape.recon_obj = lambda *a: _no_trips(recon, a)
        elif name == "half_batch":
            shape.recon_obj = _half(shape.recon_obj)
        elif name == "fewer_trips":
            shape.recon_obj = _fewer_trips(shape.recon_obj)
        elif name == "ellipsoid_altered":
            shape.recon_due = _axes_long(shape.recon_due)
        elif name == "code_altered":
            shape.recon_obj = _shifted(shape.recon_obj)
        elif name == "start_altered":
            shape.recon_due = _start_moved(shape.recon_due)
        elif name == "inputs_altered":
            shape.recon_due = _depths_scaled(shape.recon_due)
        elif name == "k1_altered":
            kern.k1_call = _k1_bad(kern.k1_call)
        elif name == "k2_altered":
            kern.k2_call = _k2_bad(kern.k2_call)
        else:
            raise ValueError(f"no fault {name!r}")
    return plant


NAMES = ("lm_unchanged", "half_batch", "fewer_trips", "code_altered", "start_altered", "inputs_altered",
         "ellipsoid_altered", "k1_altered", "k2_altered")
