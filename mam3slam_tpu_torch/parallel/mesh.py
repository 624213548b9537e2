"""Device meshes on ``torch.distributed``: the port's form of the
reference's ``jax.sharding.Mesh`` + ``shard_map``.

JAX drives every device of a mesh from one process.  Here every rank is a
process of its own: it holds the whole (replicated) problem, takes its
shard along a named axis of a ``DeviceMesh`` and meets the other ranks in
collectives over that axis's process group, so all ranks run the same
control flow and return the same replicated result.  The reference's
``psum`` is ``psum`` here (an all-reduce over the axis), its tiled
``all_gather`` is ``all_gather_rows`` and its ``axis_index`` is
``axis_rank``.

The loop server lives on rank 0.  A solve it starts on a mesh of several
ranks sends its command and tensors to the other ranks first (``send``;
they wait in ``receive``, ``dist_window_ba.serve``).  ``run_ranks``
starts one process per rank (``spawn``), joins them against a deadline
and fails as soon as one rank fails, so a rank that raises never leaves
the others blocked in a collective.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import time
import traceback
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

CUDA = torch.device("cuda")
TIMEOUT_S = 120


def init_mesh(shape: Sequence[int], names: Sequence[str], backend: str,
              init_method: str, rank: int = 0, device=CUDA,
              timeout_s: float = TIMEOUT_S) -> DeviceMesh:
    """Join the process group of ``prod(shape)`` ranks (``backend`` named:
    "nccl" or "gloo"; ``init_method`` a ``file://`` or ``tcp://`` address)
    and return the mesh of that shape with axis ``names``, on ``device``'s
    type.  Every collective fails after ``timeout_s``."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device")
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank,
        world_size=math.prod(shape),
        timeout=datetime.timedelta(seconds=timeout_s))
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def close_mesh() -> None:
    dist.destroy_process_group()


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis``."""
    y = x.clone()
    dist.all_reduce(y, group=axis_group(mesh, axis))
    return y


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh,
                    axis: str) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in rank order (the tiled
    gather).  One all-reduce of a zero buffer in which each rank fills its
    own rows, a form every backend takes for CPU and CUDA tensors; bool
    tensors travel as int32."""
    n, r, rows = axis_size(mesh, axis), axis_rank(mesh, axis), x.shape[0]
    wire = x.to(torch.int32) if x.dtype == torch.bool else x
    buf = torch.zeros((n * rows,) + x.shape[1:], dtype=wire.dtype,
                      device=x.device)
    buf[r * rows:(r + 1) * rows] = wire
    dist.all_reduce(buf, group=axis_group(mesh, axis))
    return buf != 0 if x.dtype == torch.bool else buf


def shard_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """This rank's block of dim 0 (``x.shape[0]`` a multiple of the axis
    size)."""
    n = axis_size(mesh, axis)
    rows = x.shape[0] // n
    r = axis_rank(mesh, axis)
    return x[r * rows:(r + 1) * rows]


# ---------------------------------------------------------------------------
# rank 0 drives, the other ranks follow
# ---------------------------------------------------------------------------

_HEADER = 16     # command and arguments
_DIMS = 4        # a field's rank and up to three sizes


def _device(mesh: DeviceMesh) -> torch.device:
    return torch.device(mesh.device_type)


def send(mesh: DeviceMesh, command: int, args: Sequence[int] = (),
         fields: Sequence[torch.Tensor] = ()) -> None:
    """Rank 0: broadcast a command, its integer arguments and tensors (of
    rank up to 3; bool sent as uint8, empty ones by their shape alone) to
    every rank of the mesh."""
    head = torch.zeros(_HEADER + _DIMS * len(fields), dtype=torch.int64)
    head[0], head[1] = command, len(fields)
    head[2:2 + len(args)] = torch.tensor(list(args), dtype=torch.int64)
    for i, f in enumerate(fields):
        head[_HEADER + _DIMS * i] = f.dim()
        head[_HEADER + _DIMS * i + 1:_HEADER + _DIMS * i + 1 + f.dim()] = \
            torch.tensor(f.shape, dtype=torch.int64)
    dev = _device(mesh)
    size = torch.tensor([head.numel()], dtype=torch.int64, device=dev)
    dist.broadcast(size, src=0)
    dist.broadcast(head.to(dev), src=0)
    for f in fields:
        if f.numel():
            dist.broadcast((f.to(torch.uint8) if f.dtype == torch.bool
                            else f).contiguous().to(dev), src=0)


def receive(mesh: DeviceMesh, dtypes: Sequence[torch.dtype]):
    """The other ranks' side of ``send``: (command, args [14] list,
    tensors of the given ``dtypes``, in order)."""
    dev = _device(mesh)
    size = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(size, src=0)
    head = torch.zeros(int(size), dtype=torch.int64, device=dev)
    dist.broadcast(head, src=0)
    head = head.cpu().tolist()
    fields = []
    for i in range(head[1]):
        d = head[_HEADER + _DIMS * i:_HEADER + _DIMS * (i + 1)]
        dt = dtypes[i]
        buf = torch.empty(d[1:1 + d[0]], device=dev,
                          dtype=torch.uint8 if dt == torch.bool else dt)
        if buf.numel():
            dist.broadcast(buf, src=0)
        fields.append(buf.bool() if dt == torch.bool else buf)
    return head[0], head[2:_HEADER], fields


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------

class RankFailed(RuntimeError):
    """A spawned rank raised or died; its peers were stopped."""


def _rank_main(fn, rank, shape, names, backend, device, workdir, timeout_s,
               args_blob):
    out = os.path.join(workdir, f"rank{rank}")
    try:
        args = pickle.loads(args_blob)
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        mesh = init_mesh(shape, names, backend,
                         "file://" + os.path.join(workdir, "store"), rank,
                         device, timeout_s)
        result = fn(mesh, *args)
        torch.save(result, out + ".pt")
        close_mesh()
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, shape: Sequence[int], names: Sequence[str],
              workdir: str, args: tuple = (), *, backend: str, device=CUDA,
              deadline_s: float = 300.0, timeout_s: float = TIMEOUT_S):
    """Run ``fn(mesh, *args)`` on each rank of a ``shape`` mesh (axes
    ``names``), one spawned process per rank, and return their results in
    rank order.  ``fn`` must be importable without the caller's module
    state (the children start from a fresh import).  A rank that fails
    stops its peers and raises ``RankFailed`` with its traceback; past
    ``deadline_s`` every rank is stopped and ``TimeoutError`` raised.
    ``workdir`` must be empty: it holds the rendezvous file and the
    results."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA ranks need a CUDA device")
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    n = math.prod(shape)
    # the arguments go by value (plain pickle): torch's process pickler
    # would move the caller's tensors into shared memory in place
    blob = pickle.dumps(args)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, tuple(shape), tuple(names), backend, str(device), workdir,
        timeout_s, blob)) for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        while any(p.exitcode is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.exitcode not in
                   (None, 0)]
            if bad:
                path = os.path.join(workdir, f"rank{bad[0]}.err")
                why = (open(path).read() if os.path.exists(path)
                       else f"exit code {procs[bad[0]].exitcode}")
                raise RankFailed(f"rank {bad[0]} of {n} failed:\n{why}")
            if time.monotonic() > end:
                raise TimeoutError(f"{n} ranks past {deadline_s} s")
            time.sleep(0.02)
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RankFailed(f"ranks {bad} of {n} failed")
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join(10)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n)]

