"""The port stands alone: it imports no JAX and nothing of the reference
package, nor cv2 or yaml at module level (the machine with the card has
neither), reads no file of the reference, takes the plain versions on CPU
tensors without launching a kernel, and chip_smoke.py refuses to run
without a GPU."""

import ast
import os
import pkgutil
import re
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mam3slam_tpu_torch
from mam3slam_tpu_torch import _build
from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.ops import cuda_match, cuda_orb_desc, matching, orb
from mam3slam_tpu_torch.solvers import ba

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(mam3slam_tpu_torch.__path__,
                                          "mam3slam_tpu_torch."))


def _port_sources():
    port_dir = os.path.dirname(mam3slam_tpu_torch.__file__)
    for root, _, files in os.walk(port_dir):
        yield from (os.path.join(root, f) for f in files
                    if f.endswith(".py"))


def test_port_imports_no_jax():
    code = ("import sys, importlib\n"
            f"for m in {PORT_MODULES!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'mam3slam_tpu.')) or m == 'mam3slam_tpu']\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(PORT_MODULES) >= 43
    for m in ("api", "io.settings", "io.stream", "io.euroc", "io.writers",
              "utils.verbose", "slam.background_gba", "mapstate.checkpoint",
              "io.viewer", "io.daemon", "io.images", "solvers.imu",
              "solvers.vi", "parallel", "parallel.mesh", "parallel.dist_ba",
              "parallel.dist_window_ba"):
        assert f"mam3slam_tpu_torch.{m}" in PORT_MODULES


EXAMPLES = ("torch_run_synthetic_demo", "torch_run_euroc",
            "torch_run_daemon", "torch_make_rendered_dataset")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_import_no_jax_or_image_library(name):
    """Each example twin, imported in a fresh interpreter (its ``main``
    not run), loads no JAX, nothing of the reference package and no image
    or YAML library; neither does the port's viewer and daemon."""
    code = ("import importlib.util, sys\n"
            f"path = {os.path.join(REPO, 'examples', name + '.py')!r}\n"
            "spec = importlib.util.spec_from_file_location('ex', path)\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "import mam3slam_tpu_torch.io.viewer, mam3slam_tpu_torch.io.daemon\n"
            "assert hasattr(mod, 'main')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
            "'jaxlib', 'mam3slam_tpu', 'cv2', 'matplotlib', 'PIL', 'yaml')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_imports_no_cv2_or_yaml():
    """Importing every port module and chip_smoke.py in a fresh
    interpreter loads neither cv2 nor yaml, nor matplotlib or PIL (cv2 is
    imported only inside the functions that ask for it, off the card's
    path)."""
    code = ("import sys, importlib\n"
            f"for m in {PORT_MODULES!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'yaml', 'matplotlib', 'PIL')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    pat = re.compile(r"^(import (cv2|yaml|matplotlib|PIL)|"
                     r"from (cv2|yaml|matplotlib|PIL)[ .])", re.M)
    for path in [os.path.join(REPO, "chip_smoke.py"), *_port_sources()]:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_port_sources_have_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax|import mam3slam_tpu\b|"
                     r"from mam3slam_tpu[ .])", re.M)
    for path in [os.path.join(REPO, "chip_smoke.py"), *_port_sources()]:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_port_sources_name_no_reference_path():
    """No string in the port's code (docstrings aside) names a path under
    the reference package's directory."""
    ref_part = re.compile(r"(^|[/\\])mam3slam_tpu([/\\]|$)")
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert not ref_part.search(node.value), (path, node.value)


def test_orb_pattern_is_the_references_bytes():
    with open(cuda_orb_desc.PATTERN_PATH, "rb") as f:
        port = f.read()
    with open(os.path.join(REPO, "mam3slam_tpu", "data", "orb_pattern.npy"),
              "rb") as f:
        assert port == f.read()
    assert os.path.commonpath([os.path.abspath(cuda_orb_desc.PATTERN_PATH),
                               os.path.dirname(mam3slam_tpu_torch.__file__)]
                              ) == os.path.dirname(mam3slam_tpu_torch.__file__)


def test_port_runs_without_the_reference_on_disk(tmp_path):
    """The port's package alone in a directory: it imports, loads its
    rBRIEF pattern and extracts ORB features on the CPU."""
    shutil.copytree(os.path.dirname(mam3slam_tpu_torch.__file__),
                    tmp_path / "mam3slam_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import numpy as np, torch\n"
            "from mam3slam_tpu_torch.ops import cuda_orb_desc, orb\n"
            "assert cuda_orb_desc.load_pattern().shape == (256, 4)\n"
            "img = torch.tensor(np.random.default_rng(0).uniform(0, 255, "
            "(96, 128)).astype(np.float32))\n"
            "f = orb.extract_orb(img, orb.OrbConfig(96, 128, n_features=64, "
            "n_levels=2))\n"
            "print(int(f.valid.sum()))\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 0


def test_cpu_tensors_launch_no_kernel():
    _build.reset_counts()
    rng = np.random.default_rng(0)
    img = torch.tensor(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    feats = orb.extract_orb(img, orb.OrbConfig(96, 128, n_features=64,
                                               n_levels=2))
    d = feats.desc
    matching.search_by_brute_force(d, feats.valid, feats.angle, d,
                                   feats.valid, feats.angle)
    cuda_match.fused_masked_match(
        d, feats.uv, torch.full((d.shape[0],), 8.0), feats.level,
        feats.valid, d, feats.uv, feats.level, feats.valid)
    cam = cameras.make_pinhole(100.0, 100.0, 64.0, 48.0, device="cpu")
    pts = torch.tensor(rng.uniform(1, 3, (32, 3)).astype(np.float32))
    uv = pts[:, :2] / pts[:, 2:] * 100.0 + torch.tensor([64.0, 48.0])
    ba.pose_optimization(torch.tensor([1.0, 0, 0, 0]), torch.zeros(3),
                         cam.params, cam.kind, pts, uv, torch.ones(32),
                         torch.ones(32, dtype=torch.bool))
    assert sum(_build.LAUNCHES.values()) == 0
    assert set(_build.PLAIN_CALLS) == {"orb_desc", "min_hamming2",
                                       "masked_match", "pose_opt"}


def test_batched_pose_on_cpu_tensors_launches_no_kernel(tmp_path):
    """``batched_pose_optimization`` over a mesh solves each rank's agents
    on CPU tensors with the plain version, one call per agent, and never
    launches the pose kernel."""
    from mam3slam_tpu_torch.parallel import dist_ba, mesh

    rng = np.random.default_rng(0)
    pts = torch.tensor(rng.uniform(1, 3, (3, 32, 3)).astype(np.float32))
    uv = pts[..., :2] / pts[..., 2:] * 100.0 + torch.tensor([64.0, 48.0])
    cam = cameras.make_pinhole(100.0, 100.0, 64.0, 48.0, device="cpu")
    m = mesh.init_mesh((1,), ("agent",), "gloo", f"file://{tmp_path}/s",
                       device="cpu")
    _build.reset_counts()
    try:
        res = dist_ba.batched_pose_optimization(m, cam.kind)(
            torch.tensor([[1.0, 0, 0, 0]] * 3), torch.zeros(3, 3),
            cam.params.expand(3, 8), pts, uv, torch.ones(3, 32),
            torch.ones(3, 32, dtype=torch.bool))
    finally:
        mesh.close_mesh()
    assert sum(_build.LAUNCHES.values()) == 0
    assert _build.PLAIN_CALLS["pose_opt"] == 3
    assert res.t.shape == (3, 3) and (res.n_inliers == 32).all()


def test_counts_lose_no_update_across_threads():
    """The tracking thread and the mapping worker both call kernels: the
    plain calls of more threads than cores, switching as often as the
    interpreter allows, are all counted."""
    _build.reset_counts()
    d = torch.zeros((4, 32), dtype=torch.uint8)
    ok = torch.ones(4, dtype=torch.bool)
    n_threads, n = 2 * (os.cpu_count() or 4), 100

    def calls():
        for _ in range(n):
            cuda_match.min_hamming2(d, ok, d, ok)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=calls) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _build.PLAIN_CALLS["min_hamming2"] == n_threads * n
    assert sum(_build.LAUNCHES.values()) == 0


def test_dispatch_refuses_mixed_devices():
    meta = torch.empty(3, device="meta")
    try:
        _build.is_cuda(torch.zeros(3), meta)
    except ValueError:
        return
    raise AssertionError("mixed devices accepted")


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    # alone in a directory, without the package, it fails too
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
