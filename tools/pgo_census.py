"""The essential-graph PGO in one traced benchmark run: how often it ran,
on which path, and where the time of its ``server.pgo`` spans went.

    python3 tools/pgo_census.py --workload kb8_fixture.loop1 --seed <n> \\
        --seconds 51

Runs the cell once as ``slambench/run.py --trace 1`` does, with
``solvers/pgo.py:optimize_essential_graph`` wrapped to count its calls,
their iterations and their host time (dispatch: the call returns without
waiting for the card), and prints one JSON line (``pgo_census``):

* the cell's metrics, and the window's program spans (how many, host
  ms in all) by name;
* ``calls``, ``iters`` and the PGO kernels' launches and plain calls
  (``_build.LAUNCHES`` / ``PLAIN_CALLS``) over the whole process, warm-up
  included; on the kernel path ``pgo_linearize`` launches equal ``iters``
  and ``plain_pgo`` is 0;
* the program's ``server.pgo`` spans in the window and in the profiled
  mission: how many, host ms each and in all, and the wrapped call's host
  ms beside them;
* over the profiled mission, the card's busy time inside those spans and
  up to the end of the next ``server.fuse`` span (where the first host
  read waits for the PGO's work), split by kernel group: the dense solve
  (cuSOLVER's factorisation and triangular solves, torch's copy and
  triangle around them), the PGO kernels, the segment sums, copies and
  fills, the rest; and the idle time inside the ``server.pgo`` spans.

Works on a tree whose program has no PGO kernels (its launches read 0).
Exits 2 without a card.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import slambench.run  # noqa: E402,F401  (the same environment as run.py)

GROUPS = (("dense_solve", ("getrf", "potrf", "trsv", "trsm", "syrk", "gemm",
                           "xxtrf", "dtrsv", "copy_info", "triu_tril",
                           "elementwise_kernel<128, 2")),
          ("pgo_kernels", ("pgo_",)),
          ("segsum", ("segsum",)),
          ("copies_fills", ("Memcpy", "Memset")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def overlap_ns(a0, a1, b0, b1) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="kb8_fixture.loop1")
    ap.add_argument("--seed", type=int, default=2**31 + 1)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("pgo_census: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from mam3slam_tpu_torch import _build
    from mam3slam_tpu_torch.solvers import pgo
    from slambench import harness
    from slambench import program_trace as pt
    from slambench import trace as trace_mod

    calls = []
    inner = pgo.optimize_essential_graph

    def counted(*a, **kw):
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        calls.append((kw.get("iters", 20), (time.perf_counter() - t0) * 1e3))
        return out

    pgo.optimize_essential_graph = counted
    cell = harness.load_cell(args.workload)
    out = harness.run_cell(cell, args.seed, args.seconds, True, dev,
                           T_PROCESS)
    pgo.optimize_essential_graph = inner
    tr = out["trace"]
    prog = pt.records(tr)
    report = dict(
        workload=args.workload, seed=args.seed,
        correct=out["verdict"]["correct"], frames=out["run"].frames,
        calls=len(calls), iters=sum(n for n, _ in calls),
        call_host_ms=sum(ms for _, ms in calls),
        launches={k: _build.LAUNCHES.get(k, 0) for k in (
            "pgo_linearize", "pgo_damp", "pgo_update", "segsum")},
        plain_pgo=_build.PLAIN_CALLS.get("pgo", 0),
        metrics={k: v["value"] for k, v in harness.metrics_of(
            cell, out, True).items()})
    if prog is not None:
        n, ms = defaultdict(int), defaultdict(float)
        for sp in prog.window_spans():
            n[sp.name] += 1
            ms[sp.name] += sp.ms
        report["window_spans"] = {k: [n[k], round(ms[k], 1)] for k in n}
        for part, spans in (("window", prog.window_spans("server.pgo")),
                            ("profiled", prog.profiled_spans("server.pgo"))):
            ms = [s.ms for s in spans]
            report[part] = dict(spans=len(ms), ms_total=sum(ms),
                                ms_each=[round(m, 2) for m in ms])
        # the card's time for each profiled PGO: from the span's start to
        # the end of the next server.fuse span
        fuse = prog.profiled_spans("server.fuse")
        busy, idle_in_pgo = defaultdict(int), 0
        for s in prog.profiled_spans("server.pgo"):
            end = next((f.t1 for f in fuse if f.t0 >= s.t1), s.t1)
            for name, a, b in tr.intervals:
                busy[group_of(name)] += overlap_ns(a, b, s.t0, end)
            gaps = trace_mod.idle_gaps(tr.intervals, s.t0, s.t1)
            idle_in_pgo += sum(g[1] for g in gaps)
        report["profiled"]["device_ms_by_group"] = {
            k: v / 1e6 for k, v in sorted(busy.items())}
        report["profiled"]["idle_ms_in_spans"] = idle_in_pgo / 1e6
    print("pgo_census " + json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
