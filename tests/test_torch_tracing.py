"""The port's tracer (`qsp_slam_tpu_torch/utils/tracing.py`): spans, frames,
counters, the bounded buffer, timing events, profiler ranges and
`fetch`, alone and through a tiny RGB-D run with objects and a DeepSDF
prior (the scene of `tests/test_torch_shape_system.py` at 320x240,
rendered by the port): every span where the work happens, with its
parent, once per tracked frame, keyframe or LM trip; `pose_lm_iters`
against the pose LM's own iterations; and the same trajectory and object
table, bit for bit, with the tracer on and off."""

from collections import Counter

import numpy as np
import pytest
import torch

from qsp_slam_tpu_torch.core import lie
from qsp_slam_tpu_torch.data import render as trender
from qsp_slam_tpu_torch.frontend.orb import OrbConfig
from qsp_slam_tpu_torch.frontend.pyramid import PyramidConfig
from qsp_slam_tpu_torch.models import deepsdf as tsdf
from qsp_slam_tpu_torch.models.shape_opt import ShapeOptConfig
from qsp_slam_tpu_torch.opt import pose_opt
from qsp_slam_tpu_torch.slam.system import SlamSystem
from qsp_slam_tpu_torch.slam.tracking import TrackingConfig
from qsp_slam_tpu_torch.utils import tracing
from qsp_slam_tpu_torch.utils.tracing import TRACER, Count, Span, Tracer

H, W = 240, 320
CFG = TrackingConfig(orb=OrbConfig(num_features=300, pyramid=PyramidConfig(height=H, width=W)),
                     fx=260.45, fy=260.5, cx=162.55, cy=124.85, width=W, height=H)
DEC = tsdf.DeepSDFConfig(code_dim=8, hidden=32, num_layers=4, latent_in=(2,))
OPT = ShapeOptConfig(iters=2, num_flips=1)
SYS = dict(kmax=16, nmax=2048, emax=16384, ba_window=6, omax=8, enable_loop_closing=False)
N_FRAMES = 5  # keyframes 0 and 3; the objects' second observation at keyframe 3 makes them due


# -- the tracer alone ---------------------------------------------------------------


class FakeEvent:
    """A CUDA timing event on the CPU: completes once `done` is set."""

    made = []
    done = False
    clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        FakeEvent.made.append(self)

    def record(self, stream=None):
        FakeEvent.clock += 1
        self.t = FakeEvent.clock

    def query(self):
        return FakeEvent.done

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_spans_nest_and_share_their_frame():
    tr = Tracer()
    tr.new_frame()
    with tr.span("a") as a:
        outer = tr.begin("a.b")
        with tr.span("a.b.c") as c:
            pass
        tr.end(outer)
    tr.new_frame()
    with tr.span("d") as d:
        pass
    spans = tr.records()
    assert [s.name for s in spans] == ["a.b.c", "a.b", "a", "d"]
    assert c.parent is outer and outer.parent is a and a.parent is None and d.parent is None
    assert [s.frame for s in spans] == [0, 0, 0, 1]
    assert all(s.t0 <= s.t1 and s.ms == s.host_ms for s in spans)  # on the CPU, the host interval
    assert a.t0 <= outer.t0 <= c.t0 <= c.t1 <= outer.t1 <= a.t1 <= d.t0
    assert tr.spans.keys() == {"a", "a.b", "a.b.c", "d"} and tr.report()["a"]["count"] == 1


def test_a_frame_that_raised_leaves_no_open_span():
    tr = Tracer()
    tr.new_frame()
    with pytest.raises(RuntimeError):
        tr.begin("track")
        raise RuntimeError
    tr.new_frame()
    with tr.span("capacity") as s:
        pass
    assert s.parent is None and [r.name for r in tr.records()] == ["capacity"]


def test_counters_go_to_their_frame_and_enclosing_span():
    tr = Tracer()
    tr.new_frame()
    tr.count("reads")
    with tr.span("x") as x:
        tr.count("reads", 3)
        with tr.span("x.y") as y:
            tr.count("iters")
        tr.count("reads")
    tr.new_frame()
    tr.count("reads")
    counts = [r for r in tr.records() if isinstance(r, Count)]
    assert [(c.name, c.n, c.frame, c.parent) for c in counts] == [("reads", 1, 0, None), ("reads", 4, 0, x),
                                                                    ("iters", 1, 0, y), ("reads", 1, 1, None)]
    assert x.t0 <= counts[1].t <= y.t0 <= counts[2].t <= y.t1 <= x.t1 <= counts[3].t


def test_the_buffer_keeps_the_newest_records():
    tr = Tracer(capacity=8)
    for i in range(20):
        tr.new_frame()
        with tr.span("s"):
            pass
    recs = tr.records()
    assert len(recs) == 8 and [r.frame for r in recs] == list(range(12, 20))


def test_events_resolve_once_complete_and_a_disabled_tracer_makes_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(FakeEvent, "made", [])
    monkeypatch.setattr(FakeEvent, "done", False)
    monkeypatch.setattr(FakeEvent, "clock", 0)
    off = Tracer(enabled=False)
    off.new_frame()
    with off.span("s") as s:
        off.count("n")
    assert not FakeEvent.made and not off.records() and not off.spans and s.host_ms >= 0.0
    tr = Tracer()
    tr.new_frame()
    with tr.span("s") as s:
        pass
    assert len(FakeEvent.made) == 2 and s.ms is None
    tr.new_frame()  # the pair has not completed: nothing waits for it
    assert s.ms is None
    FakeEvent.done = True
    tr.new_frame()
    assert s.ms == 1.0
    with tr.span("t") as t:  # the resolved pair is used again
        pass
    assert len(FakeEvent.made) == 2 and [r.ms for r in tr.records()] == [1.0, 1.0] and t.ms == 1.0


def test_fetch_counts_each_read_and_synchronise():
    n0 = sum(r.n for r in TRACER.records() if isinstance(r, Count) and r.name == tracing.HOST_READS)
    got = tracing.fetch(torch.arange(3))
    assert got.device.type == "cpu" and got.tolist() == [0, 1, 2]
    assert tracing.fetch(device=torch.device("cpu")) is None
    n1 = sum(r.n for r in TRACER.records() if isinstance(r, Count) and r.name == tracing.HOST_READS)
    assert n1 - n0 == 2


# -- a tiny RGB-D run -------------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    scene = trender.make_scene(num_objects=3, seed=2, device="cpu")
    base = lie.exp_se3(torch.tensor([0, 0, 0, 0.44, 0, 0], dtype=torch.float32))
    out = []
    for i in range(N_FRAMES):
        Tcw = lie.exp_se3(torch.tensor([0.04 * i, 0, 0, 0, 0, 0], dtype=torch.float32)) @ base
        g, d, inst = trender.render_scene(scene, Tcw, CFG.intr, height=H, width=W)
        det = trender.gt_detections(scene, Tcw, CFG.intr, width=W, height=H, instance=inst)
        out.append((g.numpy(), d.numpy(), {k: v.numpy() for k, v in det.items()}))
    return out


def _system():
    params = tsdf.init_decoder(torch.Generator().manual_seed(0), DEC, device="cpu")
    return SlamSystem(CFG, shape_prior=(params, DEC, OPT), device="cpu", **SYS)


@pytest.fixture(scope="module")
def runs(frames):
    """The run with the tracer on, under a CPU profiler with one `frame_<i>`
    range per frame, counting the pose LM's iterations; then the same run
    with the tracer off."""
    torch.set_num_threads(2)
    solve, iters = pose_opt.solve_or_nan, []

    def counted(*a):  # one solve per pose LM iteration
        iters.append(1)
        return solve(*a)

    on = _system()
    first = TRACER.frame + 1
    pose_opt.solve_or_nan = counted
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for i, (g, d, det) in enumerate(frames):
                with torch.profiler.record_function(f"frame_{i}"):
                    on.track_rgbd(g, d, det)
    finally:
        pose_opt.solve_or_nan = solve
    recs = [r for r in TRACER.records() if r.frame >= first]
    TRACER.enabled = False
    try:
        n0 = len(TRACER.records())
        off = _system()
        for g, d, det in frames:
            off.track_rgbd(g, d, det)
        assert len(TRACER.records()) == n0
    finally:
        TRACER.enabled = True
    return {"on": on, "off": off, "recs": recs, "prof": prof, "first": first, "lm_iters": len(iters)}


def _spans(runs):
    return [r for r in runs["recs"] if isinstance(r, Span)]


def test_every_span_where_the_work_happens(runs):
    sysm, spans = runs["on"], _spans(runs)
    assert sysm.stats["kf_frames"] == [0, 3] and sysm.stats["frames"] == N_FRAMES - 1
    by = Counter((s.name, s.parent.name if s.parent else None) for s in spans)
    tracked, kfs = N_FRAMES - 1, 1  # the first frame initialises; keyframe 3 is inserted
    trips = by[("shapes.trip", "shapes")]
    assert trips == OPT.iters  # one shape step of one chunk
    assert by == {
        ("capacity", None): N_FRAMES, ("loop", None): kfs + 1, ("objects", None): kfs + 1,
        ("track.features", None): 1,  # the first frame's features, outside any tracked frame
        ("track", None): tracked, ("track.features", "track"): tracked, ("track.search", "track"): tracked,
        ("track.pose", "track"): tracked, ("map.insert", None): kfs, ("map.local_ba", None): kfs,
        ("objects.planes", "objects"): kfs + 1, ("objects.fit", "objects"): kfs + 1,
        ("objects.refine", "objects"): kfs + 1, ("shapes", "objects"): kfs + 1,
        ("shapes.gather", "shapes"): kfs + 1, ("shapes.trip", "shapes"): trips,
        ("shapes.jacobian", "shapes.trip"): trips}
    # Each frame's spans share its id, one id per `track_rgbd` call.
    assert sorted({s.frame for s in spans}) == list(range(runs["first"], runs["first"] + N_FRAMES))
    assert all(s.frame == s.parent.frame for s in spans if s.parent)
    assert not any(s.name.startswith("frame_") for s in spans)


def test_stats_keep_their_keys_and_take_the_spans_durations(runs):
    sysm, spans = runs["on"], _spans(runs)
    for key, name in (("track_ms", "track"), ("ba_ms", "map.local_ba"), ("obj_ms", "objects")):
        host = [s.host_ms for s in spans if s.name == name and (name != "objects" or s.frame > runs["first"])]
        assert sysm.stats[key] == host and host, key
    assert "inliers" not in sysm.stats and len(sysm.stats["track_ok"]) == N_FRAMES - 1
    assert len(runs["off"].stats["track_ms"]) == N_FRAMES - 1  # timed with the tracer off too


def test_counters_count_the_pose_iterations_and_every_read(runs):
    counts = [r for r in runs["recs"] if isinstance(r, Count)]
    pose = [c for c in counts if c.name == "pose_lm_iters"]
    assert sum(c.n for c in pose) == runs["lm_iters"] > 0 and all(c.parent.name == "track.pose" for c in pose)
    assert sum(c.n for c in pose) <= 40 * (N_FRAMES - 1)
    trips = [c for c in counts if c.name == "local_ba_trips"]
    assert 1 <= sum(c.n for c in trips) <= 15 and all(c.parent.name == "map.local_ba" for c in trips)
    reads = Counter()
    for c in counts:
        if c.name == tracing.HOST_READS:
            reads[c.parent.name if c.parent else None] += c.n
    # the capacity check's one read per frame; per pose LM round its damping's copy to the device, per
    # iteration the early exit's read and the step's pose assembly (`rt_to_se3`)
    assert reads["capacity"] == N_FRAMES and reads["track"] >= N_FRAMES - 1
    assert reads["track.pose"] == 2 * runs["lm_iters"] + 4 * (N_FRAMES - 1)
    assert reads["map.local_ba"] >= sum(c.n for c in trips) + 1


def test_the_profiler_shows_every_span_inside_its_frame(runs):
    spans = _spans(runs)
    names = {s.name for s in spans}
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in runs["prof"].profiler.kineto_results.events()
              if e.name().startswith("frame_") or e.name() in names]
    frames = [(a, b) for n, a, b in events if n.startswith("frame_")]
    assert len(frames) == N_FRAMES
    assert Counter(n for n, _, _ in events if n in names) == Counter(s.name for s in spans)
    for n, a, b in events:
        assert any(f0 <= a and b <= f1 for f0, f1 in frames), n


def test_the_tracer_changes_no_bit_of_the_result(runs):
    on, off = runs["on"], runs["off"]
    np.testing.assert_array_equal(np.stack(on.trajectory), np.stack(off.trajectory))
    assert int(on.objects.valid.sum()) == 3 and bool(on.objects.shape_ok.any())
    for name in on.objects._fields:
        a, b = getattr(on.objects, name), getattr(off.objects, name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, name
