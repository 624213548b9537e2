"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all
started together, and the objects link into ONE shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), which
is loaded with ``ctypes``.  ``build_log`` keeps ptxas's report of each
kernel (registers, shared memory, spills).  The library lands in
``build/mam3slam_tpu_torch/`` at the repository root, named by a hash of
the sources and flags: the first kernel launch of a process builds it
when it is missing, so a fresh checkout needs no separate build step.

Every kernel wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel, and every plain PyTorch version adds one to ``PLAIN_CALLS[name]``
(``count_plain``), so a run can show which path it went through.  Both
counts are taken under one lock: the tracking thread and the mapping
worker launch kernels concurrently.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "mam3slam_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the repository's host-side C++ (native/*.cc), built for the host that
# runs it: no -march=native, so a library never meets a CPU it was not
# built on
NATIVE_DIR = os.path.join(os.path.dirname(_PKG_DIR), "native")
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
HOST_LIBS = ("-lz", "-lpthread")

LAUNCHES: collections.Counter = collections.Counter()
PLAIN_CALLS: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the kernels' launchers: each returns cudaGetLastError()
_SIGNATURES = {
    "mam3_orb_desc": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P],
    "mam3_masked_match": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
                          _P, _P, _P, _P],
    "mam3_min_hamming2": [_P, _P, _I, _P, _P, _I, _P, _P, _P, _P],
    "mam3_pose_opt": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P],
    "mam3_segsum": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_host_lock = threading.Lock()
_lib = None
_host_libs = {}
build_seconds = None  # wall time of this process's nvcc runs (None: cached)
build_log = ""        # their ptxas reports


def reset_counts() -> None:
    with _count_lock:
        LAUNCHES.clear()
        PLAIN_CALLS.clear()


def count_plain(name: str) -> None:
    """One call of the plain version of kernel ``name``."""
    with _count_lock:
        PLAIN_CALLS[name] += 1


def is_cuda(*tensors: torch.Tensor) -> bool:
    """Dispatch on where the tensors lie: True when all are on the current
    CUDA device (launch the kernel), False when all are on the CPU (the
    plain version).  Mixed or other devices raise."""
    devices = {t.device for t in tensors}
    if len(devices) == 1:
        (dev,) = devices
        if dev.type == "cpu":
            return False
        if dev.type == "cuda" and dev.index == torch.cuda.current_device():
            return True
    raise ValueError(f"tensors on unsupported or mixed devices: {devices}")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmam3kernels_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit to build the "
                           "mam3slam_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds) -> str:
    """Run the commands together and read every one's output to its end;
    raise on the first that failed, else return their joined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n" + log)
    return "".join(logs)


def _compile(out: str) -> None:
    global build_seconds, build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    objs = {src: f"{tmp}.{os.path.basename(src)}.o"
            for src in _sources() if src.endswith(".cu")}
    t0 = time.perf_counter()
    try:
        build_log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", src, "-o", obj]
                              for src, obj in objs.items()])
        _run_all([[_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", f"{tmp}.so",
                   *objs.values()]])
    finally:
        for obj in objs.values():
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(f"{tmp}.so", out)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call the C launcher ``name`` on the current stream; raise on a CUDA
    error, count the launch otherwise."""
    fn = getattr(library(), name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    with _count_lock:
        LAUNCHES[name.removeprefix("mam3_")] += 1


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Validate a kernel argument: dtype, shape (None = any extent) and
    contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if len(t.shape) != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def host_library(name: str) -> ctypes.CDLL:
    """``native/<name>.cc`` built with this host's g++ into ``BUILD_DIR``
    on first use (named by a hash of the source and flags) and loaded;
    raises when the build or the load fails."""
    with _host_lock:
        if name not in _host_libs:
            src = os.path.join(NATIVE_DIR, f"{name}.cc")
            h = hashlib.sha256(" ".join(HOST_FLAGS + HOST_LIBS).encode())
            with open(src, "rb") as f:
                h.update(f.read())
            out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
            if not os.path.exists(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.so"
                _run_all([["g++", *HOST_FLAGS, src, *HOST_LIBS, "-o", tmp]])
                os.replace(tmp, out)
            _host_libs[name] = ctypes.CDLL(out)
        return _host_libs[name]
