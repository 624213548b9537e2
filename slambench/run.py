"""Run one cell of the benchmark once and print its result.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout that holds the program
(``mam3slam_tpu_torch``) beside this folder.  Set-up (imports, the
kernel library, rendering the cell's frames on the card, a warm-up
system) is timed from process start to the first timed frame and its
parts are printed on an earlier line; then back-to-back missions run for
``--seconds``; then the check against the plain references.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its
limit.  Exits 2 without a card (or with fewer than the cell asks for),
3 when the program cannot be imported, 4 when JAX or the reference
package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# caches of the program's builds stay in the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("USE_FLAX", "0")
# one process, few threads: the program's host side is one Python thread
# that launches work on the card; idle thread pools spinning beside it
# take cores from it on a machine that shares its cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def smi(query: str = "name,power.limit") -> str:
    """One ``nvidia-smi --query-gpu`` line of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t = time.perf_counter()
    import torch

    from slambench import harness

    torch_s = time.perf_counter() - t

    cell = harness.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: the cell needs {chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import mam3slam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"slambench: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    torch.cuda.set_device(dev)
    torch.zeros(1, device=dev)
    cuda_init_s = time.perf_counter() - t
    # a fixed piece of pure-Python work: how fast the host runs this
    # process, beside the host-clock metrics it sets
    t = time.perf_counter()
    sum(range(3_000_000))
    host_probe_s = time.perf_counter() - t
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           dev, T_PROCESS)
    if out["forbidden"]:
        print(f"slambench: loaded {out['forbidden']} (JAX or the reference "
              f"package) in the process that reports", file=sys.stderr)
        return 4
    run, verdict = out["run"], out["verdict"]
    card = smi()
    clocks = smi(CLOCKS)
    print("setup " + json.dumps(dict(
        setup_s=run.setup_s, torch_s=torch_s,
        cuda_init_s=cuda_init_s, host_probe_s=host_probe_s,
        **run.setup_parts, card=card,
        clocks_after=f"{CLOCKS}: {clocks}")))
    print("window " + json.dumps(dict(
        seconds=run.window_s, frames=run.frames, missions=run.missions,
        missions_complete=run.missions_complete,
        mission_walls=run.mission_walls, check_s=out["check_s"],
        events=[r.events for r in out["records"]],
        agents=verdict["detail"])))
    if args.trace:
        totals = {}
        for name, t0, t1, _ in out["trace"].timed_spans():
            totals[name] = totals.get(name, 0.0) + t1 - t0
        print("spans " + json.dumps(dict(seconds=totals,
                                         calls=len(run.latencies_s))))
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=chips, memory_peak_bytes=int(out["memory_peak"]))
    result = dict(correct=bool(verdict["correct"]),
                  attempted=int(verdict["attempted"]),
                  failed=int(verdict["failed"]),
                  metrics=harness.metrics_of(cell, out, bool(args.trace)),
                  device=device)
    if args.trace:
        tr = out["trace"]
        device.update(busy_s=tr.busy_s(), window_s=tr.window_s())
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: dict(value=v, limit=lim)
                        for name, v, lim in verdict["rows"]}
    if verdict["faults"]:
        result["checks"]["faults"] = verdict["faults"]
    for name, v, lim in verdict["rows"]:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    for f in verdict["faults"]:
        print(f"check fault: {f}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
