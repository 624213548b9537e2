"""What the program's own spans and counters say about a cell, beside
what the benchmark's line says, in three modes (one a process):

    python3 slambench/program_report.py traced --workload <cell> \\
        --seed <n> --seconds 51
    python3 slambench/program_report.py overhead --workload <cell> \\
        --seeds <n> <n> <n> --seconds 51
    python3 slambench/program_report.py span_cost

``traced`` runs the cell once as ``run.py --trace 1`` does and prints
one JSON line (``report``): the per-layer metrics; the window's span
counts and host time by name; the server's split against the
benchmark's ``server_ms_per_kf``; the window's counters; and over the
profiled mission the two breakdowns by program span
(``program_trace.idle_gaps_program``, ``idle_by_program_span``, with the
share of idle time named by a span) beside the benchmark's own
``idle_gaps``.

``overhead`` runs the cell untraced (no wrappers, no profiler) with the
program's tracer off, on, on, off for each seed, in one process, and
prints ``fps`` and ``frame_ms_p50`` of each run (``overhead`` lines).
``span_cost`` times 10**6 disabled and 10**6 enabled spans on the host.
Each exits 2 without a card.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import slambench.run  # noqa: E402,F401  (the same environment as run.py)


def totals(spans):
    """By span name: how many, and host ms in all."""
    n, ms = defaultdict(int), defaultdict(float)
    for s in spans:
        n[s.name] += 1
        ms[s.name] += s.ms
    return dict(n), {k: round(v, 3) for k, v in ms.items()}


def traced(args, dev):
    from slambench import harness
    from slambench import program_trace as pt
    from slambench import trace as trace_mod

    cell = harness.load_cell(args.workload)
    out = harness.run_cell(cell, args.seed, args.seconds, True, dev,
                           T_PROCESS)
    tr = out["trace"]
    metrics = harness.metrics_of(cell, out, True)
    prog = pt.records(tr)
    if prog is None:
        print("program_report: the program recorded nothing",
              file=sys.stderr)
        return 1
    win = prog.window_spans()
    n_spans, total = totals(win)
    n_server = sum(s.name == "server" for s in win)
    n_corr = sum(s.name in ("server.correct", "server.merge") for s in win)
    m = {k: v["value"] for k, v in metrics.items()}
    split = None
    if n_server and "server_ms_per_kf" in m:
        parts = (m.get("server_pr_ms_per_kf", 0.0)
                 + m.get("server_verify_ms_per_kf", 0.0)
                 + m.get("server_correct_ms_per_event", 0.0)
                 * n_corr / n_server)
        split = dict(keyframes=n_server, corrections=n_corr,
                     parts_ms_per_kf=parts,
                     program_server_ms_per_kf=total["server"] / n_server,
                     wrapper_server_ms_per_kf=m["server_ms_per_kf"],
                     parts_over_wrapper=parts / m["server_ms_per_kf"])
    counts = defaultdict(int)
    for c in prog.counts:
        if prog.in_window(c.t):
            counts[c.name] += c.amount
    gaps = trace_mod.idle_gaps(tr.intervals, *tr.window_ns)
    by_span, named = pt.idle_by_program_span(prog, gaps)
    report = dict(
        workload=args.workload, seed=args.seed, correct=out["verdict"][
            "correct"], frames=out["run"].frames, metrics=m,
        spans_n=n_spans, spans_ms=total, counts=dict(counts), server=split,
        idle_gaps=tr.breakdown()["idle_gaps"],
        idle_gaps_program=pt.idle_gaps_program(prog, gaps),
        idle_by_program_span=by_span, idle_named_share=named,
        idle_s=sum(g[1] for g in gaps) / 1e9, busy_s=tr.busy_s(),
        window_s=tr.window_s())
    print("report " + json.dumps(report))
    return 0


def overhead(args, dev):
    from slambench import harness
    from slambench import program_trace as pt

    cell = harness.load_cell(args.workload)
    tracer = pt.tracer()
    for seed in args.seeds:
        for on in (False, True, True, False):
            if tracer is not None:
                tracer.take()
                (tracer.enable if on else tracer.disable)()
            out = harness.run_cell(cell, seed, args.seconds, False, dev,
                                   time.perf_counter())
            if tracer is not None:
                tracer.disable()
                n = len(tracer.take().spans)
            run = out["run"]
            print("overhead " + json.dumps(dict(
                seed=seed, tracer=on, spans=n if tracer else None,
                fps=run.frames / run.window_s,
                frame_ms_p50=statistics.median(run.latencies_s) * 1e3,
                correct=out["verdict"]["correct"])), flush=True)
    return 0


def span_cost(args, dev):
    from mam3slam_tpu_torch.utils.timing import TRACER

    n = 10**6
    res = {}
    for on in (False, True, False, True):
        (TRACER.enable if on else TRACER.disable)()
        t = time.perf_counter_ns()
        for _ in range(n):
            with TRACER.span("track.read"):
                pass
        span = time.perf_counter_ns() - t
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        res.setdefault("on" if on else "off", []).append(
            (span - (time.perf_counter_ns() - t)) / n)
        TRACER.disable()
        TRACER.take()
    print("span_cost " + json.dumps(dict(ns_per_span=res, loops=n)))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("traced", "overhead", "span_cost"))
    ap.add_argument("--workload", default="kb8_fixture.loop1")
    ap.add_argument("--seed", type=int, default=2**31 + 1)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("program_report: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return dict(traced=traced, overhead=overhead,
                span_cost=span_cost)[args.mode](args, dev)


if __name__ == "__main__":
    sys.exit(main())
