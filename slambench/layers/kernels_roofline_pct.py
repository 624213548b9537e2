"""kernels_roofline_pct: layer "kernels": the program's five hand-written
kernels (``orb_desc``, ``masked_match``, ``min_hamming2``, ``pose_opt``,
``segsum``).  The least time of their launches in the profiled mission (the
larger of operations over the peak rate and bytes over the memory rate,
from each launch's own arguments, ``ref/work.py``) over their device
time.  Each kernel's device time is its mean in the profiler's trace
times the launches recorded, since the profiler drops some kernels."""

import math

from slambench.ref import work

P = "mam3slam_tpu_torch.ops."


CALLS = {
    "orb_desc": (P + "cuda_orb_desc:ic_brief",
                 lambda a, k, out: (tuple(a[0].shape), a[2], a[3], a[4],
                                    out[0])),
    "masked_match": (P + "cuda_match:fused_masked_match",
                     lambda a, k, out: (a[1], a[2], a[3], a[4], a[6], a[7],
                                        a[8])),
    "min_hamming2": (P + "cuda_match:min_hamming2",
                     lambda a, k, out: (a[1], a[3])),
    "pose_opt": (P + "cuda_pose:pose_optimization_batched",
                 lambda a, k, out: (a[7], out[3], a[4].shape[1], a[3],
                                    k.get("rounds", a[8] if len(a) > 8 else 4),
                                    k.get("iters", a[9] if len(a) > 9 else 5))),
    "segsum": (P + "segsum:segment_sum",
               lambda a, k, out: (a[0].start, a[0].end, a[0].n_out,
                                  tuple(a[1].shape), a[1].dtype)),
}
# the device kernel each wrapper launches, as torch.profiler names it
KERNEL_NAMES = {"orb_desc": "orb_desc_kernel",
                "masked_match": "masked_match_kernel",
                "min_hamming2": "best2_mma_kernel",
                "pose_opt": "pose_kernel",
                "segsum": "segsum_kernel"}


def _bound_s(name, row):
    if name == "orb_desc":
        shape, xy, lvl, hw, angle = row
        if len(xy) == 0:
            return None
        return work.bound_s(*work.describe_work(shape, xy, lvl, hw, angle))
    if name == "masked_match":
        if len(row[3]) == 0:
            return None
        return work.bound_s(*work.masked_work(*row))
    if name == "min_hamming2":
        if len(row[0]) == 0:
            return None
        return work.bound_s(*work.best2_work(*row))
    if name == "pose_opt":
        valid, n_in, n, kind, rounds, iters = row
        if valid.shape[0] == 0:
            return None
        vb = valid.sum(dim=1).tolist()
        ib = n_in.tolist()
        ops = sum(work.pose_work(v, i, n, kind, rounds, iters)[0]
                  for v, i in zip(vb, ib))
        return work.bound_s(ops, work.F32_OPS, len(vb) * (26 * n + 92))
    start, end, n_out, shape, dtype = row
    if n_out * math.prod(shape[1:]) == 0:
        return None
    return work.bound_s(*work.segsum_work(start, end, n_out, shape, dtype))


def read(trace, run):
    by_name = trace.device_by_name()
    least = spent = 0.0
    for name, rows in trace.calls.items():
        dev = [v for k, v in by_name.items() if KERNEL_NAMES[name] in k]
        n_dev = sum(c for c, _ in dev)
        if not n_dev:
            continue
        mean_dev_s = sum(ns for _, ns in dev) / n_dev / 1e9
        bounds = [b for b in (_bound_s(name, r) for r in rows) if b is not None]
        least += sum(bounds)
        spent += mean_dev_s * len(bounds)
    return 100.0 * least / spent if spent > 0 else None
