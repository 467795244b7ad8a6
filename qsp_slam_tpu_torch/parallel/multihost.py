"""Ranks on `torch.distributed`: bring-up, the launcher, and the two-rank
sharded-BA worker (counterpart of `qsp_slam_tpu/parallel/multihost.py`).

The reference widens one controller's mesh across processes with
`jax.distributed` and cross-process global arrays.  Here every process is
a rank of one process group (`initialize`, over `tcp://coordinator`):
each holds the whole replicated problem and slices its own block, so the
sharded solvers run unchanged from one card to several hosts.

`spawn_ranks` starts N ranks of this module on localhost, each
`--target module:function` (or, without one, the worker below), and
kills every sibling when one fails or the time runs out.  The sharded
command lines (`run_tum --mesh N`, `run_kitti --mesh N`), the tests and
`chip_smoke.py` launch their ranks with it.

    python -m qsp_slam_tpu_torch.parallel.multihost --orchestrate [--num-processes N] [--cpu]
    python -m qsp_slam_tpu_torch.parallel.multihost --coordinator localhost:12421 \\
        --num-processes 2 --process-id 0 [--cpu] [--bench]
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import choose_backend, rank_device

# The rendezvous and each collective fail after this long: a rank waits
# in one only while a sibling finishes its part of the same step (a frame
# or an LM trip).  A whole run of ranks is held to `RUN_LIMIT_S` (the
# `--mesh` command lines' limit) unless `spawn_ranks` is given another.
COLLECTIVE_TIMEOUT_S = 300.0
RUN_LIMIT_S = 6 * 3600.0


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    cpu: bool = False,
) -> torch.device:
    """Join the process group of `num_processes` ranks over
    `tcp://coordinator_address` as rank `process_id` (backend by
    `mesh.choose_backend`, printed on stderr); returns the rank's device,
    made current when it is a card.  The rendezvous and every collective
    fail after `COLLECTIVE_TIMEOUT_S`."""
    device = rank_device(process_id, cpu)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = choose_backend(num_processes, device.type)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    print(f"[rank {process_id}/{num_processes}] torch.distributed backend {backend} on {device}",
          file=sys.stderr, flush=True)
    return device


def global_ba_inputs(mesh, Tcw, points, cam_fixed, edges, axis: str = "edges"):
    """A BA problem for the edge-sharded solver with its edges padded to the
    mesh size.  Every rank holds the whole replicated problem and slices
    its own block inside the solver, so nothing is globalized here."""
    from .sharded_ba import pad_edges_for_mesh

    return Tcw, points, cam_fixed, pad_edges_for_mesh(edges, mesh.shape[axis])


class RankResult(NamedTuple):
    rank: int
    stdout: str
    stderr: str

    def json(self) -> dict:
        """The last line of the rank's standard output that is a JSON object."""
        return json.loads([line for line in self.stdout.splitlines() if line.startswith("{")][-1])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn_ranks(
    num_ranks: int,
    args=(),
    *,
    target: str | None = None,
    cpu: bool = False,
    timeout: float = RUN_LIMIT_S,
) -> list[RankResult]:
    """Run `num_ranks` rank processes of this module on localhost and return
    their output in rank order.  Rank r runs `target` ("module:function",
    called with `args` after "{rank}" in them becomes r) or, without one,
    the sharded-BA worker with `args` as its flags.  When a rank exits
    non-zero every sibling is killed and RuntimeError raised with its
    stderr; after `timeout` seconds all are killed and TimeoutError raised."""
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="qsp_ranks_") as tmp:
        procs, files = [], []
        try:
            for r in range(num_ranks):
                cmd = [sys.executable, "-m", "qsp_slam_tpu_torch.parallel.multihost",
                       "--coordinator", f"localhost:{port}", "--num-processes", str(num_ranks),
                       "--process-id", str(r)] + (["--cpu"] if cpu else [])
                if target is not None:
                    cmd += ["--target", target, "--", *(str(a).replace("{rank}", str(r)) for a in args)]
                else:
                    cmd += list(args)
                out = open(os.path.join(tmp, f"{r}.out"), "w+")
                err = open(os.path.join(tmp, f"{r}.err"), "w+")
                files.append((out, err))
                procs.append(subprocess.Popen(cmd, cwd=repo, stdout=out, stderr=err, text=True))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    time.sleep(0.5)  # the siblings a failure takes with it report theirs
                    codes = [p.poll() for p in procs]
                    msg = []
                    for r, c in enumerate(codes):
                        if c not in (None, 0):
                            files[r][1].seek(0)
                            msg.append(f"rank {r} of {num_ranks} exited with {c}:\n{files[r][1].read()[-3000:]}")
                    raise RuntimeError("\n".join(msg))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{num_ranks} ranks still running after {timeout} s (exit codes {codes})")
                time.sleep(0.05)
            results = []
            for r, (out, err) in enumerate(files):
                out.seek(0)
                err.seek(0)
                results.append(RankResult(r, out.read(), err.read()))
            return results
        finally:
            # A failed or late rank must not leave a sibling blocked in a
            # collective: kill by handle, then reap.
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for out, err in files:
                out.close()
                err.close()


def _problem(device):
    """The worker's problem: the reference worker's 6 keyframes, 200 points."""
    from ..data.synthetic import ba_edges, make_ba_problem

    prob = make_ba_problem(num_cams=6, num_points=200, obs_per_point=4, seed=3)
    cam_fixed = torch.zeros(6, dtype=torch.bool, device=device)
    cam_fixed[0] = True
    return (prob, torch.from_numpy(prob.Tcw_init).to(device), torch.from_numpy(prob.points_init).to(device),
            cam_fixed, ba_edges(prob, device))


def _worker(args) -> None:
    """Rank worker: one edge-sharded BA over every rank, its cost printed;
    with --bench also the median wall time of a 10-trip BA (3 runs)."""
    from .sharded_ba import make_edge_mesh, sharded_local_ba

    device = torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())
    mesh = make_edge_mesh(device=device)
    prob, T0, p0, fixed, edges = _problem(device)
    gT, gp, gfix, gedges = global_ba_inputs(mesh, T0, p0, fixed, edges)
    _, _, cost = sharded_local_ba(mesh, gT, gp, gfix, gedges, prob.intr, iters=6, pre_padded=True)
    out = {"process_id": args.process_id, "process_count": dist.get_world_size(),
           "global_devices": mesh.size, "backend": mesh.backend, "device": str(device), "cost": float(cost)}
    if args.bench:
        def run():
            r = sharded_local_ba(mesh, gT, gp, gfix, gedges, prob.intr, iters=10, pre_padded=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return r

        run()
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        out["t_ms"] = float(np.median(ts)) * 1e3
    print(json.dumps(out), flush=True)


def orchestrate(num_processes: int = 2, cpu: bool = False) -> dict:
    """The same edge-sharded BA at world size 1 and at `num_processes`, each
    rank a process of its own on this host.  The reference's "1 process x
    4 devices" has no form here (one process is one rank), so the world-1
    run is the baseline: the ratio is what the extra ranks, their process
    boundaries and collectives add on shared cores or a shared card."""
    one = [r.json() for r in spawn_ranks(1, ["--bench"], cpu=cpu)]
    many = [r.json() for r in spawn_ranks(num_processes, ["--bench"], cpu=cpu)]
    t1, tn = one[0]["t_ms"], max(o["t_ms"] for o in many)
    result = {
        "problem": "6 KF / 200 pts edge-sharded BA, 10 LM trips",
        "backend": many[0]["backend"], "t_1proc_ms": t1, f"t_{num_processes}proc_ms": tn,
        "cross_process_overhead": tn / t1 - 1.0,
        "cost_agrees": abs(one[0]["cost"] - many[0]["cost"]) < 1e-4 * abs(one[0]["cost"]) + 1e-6,
        "note": (f"world size 1 against {num_processes} ranks on this host, each rank one process: they "
                 "share its cores (and card), so the ratio is the cost of the ranks' boundaries and "
                 "collectives, not a scaling figure"),
    }
    print(json.dumps({"multihost": result}), flush=True)
    return result


def cli_mesh(module: str, argv: list[str], num_ranks: int | None, cpu: bool):
    """The `--mesh N` of a command line: (None, None) without it; from a
    process outside any group with N > 1, (None, rank 0's JSON) after
    running the command `module` with `argv` as N ranks (their stderr goes
    to this stderr, rank 0's stdout to this stdout; a failed rank raises);
    else (the mesh, None), the ranks' `map` axis (size 1 for N = 1)."""
    from .mesh import make_mesh

    if not num_ranks:
        return None, None
    if num_ranks > 1 and not dist.is_initialized():
        results = spawn_ranks(num_ranks, argv, target=f"{module}:main", cpu=cpu)
        for r in results:
            sys.stderr.write(r.stderr)
        sys.stderr.flush()
        sys.stdout.write(results[0].stdout)
        sys.stdout.flush()
        return None, results[0].json()
    return make_mesh(num_ranks, axis="map", device="cpu" if cpu else None), None


def _call_target(spec: str, argv: list[str]):
    module, _, name = spec.partition(":")
    return getattr(importlib.import_module(module), name)(argv)


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    rest = []
    if "--" in argv:
        at = argv.index("--")
        argv, rest = argv[:at], argv[at + 1:]
    p = argparse.ArgumentParser()
    p.add_argument("--orchestrate", action="store_true")
    p.add_argument("--coordinator")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--cpu", action="store_true", help="ranks on the CPU (gloo) instead of CUDA")
    p.add_argument("--target", default=None, metavar="MODULE:FUNCTION",
                   help="run FUNCTION(argv after --) as this rank instead of the worker")
    p.add_argument("--bench", action="store_true")
    args = p.parse_args(argv)
    if args.orchestrate:
        return orchestrate(args.num_processes or 2, args.cpu)
    if not args.coordinator or args.num_processes is None or args.process_id is None:
        p.error("--coordinator, --num-processes and --process-id are required in worker mode "
                "(or use --orchestrate)")
    torch.set_num_threads(1)
    initialize(args.coordinator, args.num_processes, args.process_id, cpu=args.cpu)
    try:
        if args.target:
            _call_target(args.target, rest)
        else:
            _worker(args)
    finally:
        dist.destroy_process_group()
    from ..ops.fast_nms import fast_score_nms_pyramid
    from ..ops.hamming import hamming_packed

    print(f"[rank {args.process_id}/{args.num_processes}] launches " + json.dumps(
        {"fast_nms": fast_score_nms_pyramid.launches, "hamming": hamming_packed.launches}),
        file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()

