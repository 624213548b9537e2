"""Port parity of the distributed solvers (``mam3slam_tpu_torch.parallel``)
after tests/test_dist_ba.py and tests/test_two_level_mesh.py, with their
tolerances.

One scene (tests/test_ba.py's ``make_scene``: 6 cameras, the first two
fixed, 252 points, the free poses and the points perturbed) as an edge
list and as a window problem, and eight agents' pose problems.  The port
runs every distributed solver in ranks spawned on the CPU over gloo
(``torch_dist_ranks.solvers``): a world of 4 on one axis, a world of 2,
a (host, chip) = (2, 2) mesh reducing over "chip" with the agents over
"host", and a world of 1 in this process.  The reference runs the same
functions on meshes of the conftest's virtual CPU devices of the same
sizes, once per module.  Each port result is held to the reference's at
the same mesh size and to the port's single-device solver, at the
reference tests' tolerances (cameras 5e-3, or 2e-2 for the psum-CG
solver beside the dense one; points 2e-2; under 2% of the inlier
classifications apart); every rank returns the same replicated result,
bit for bit; a rank that raises fails the run at once."""

import concurrent.futures
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mam3slam_tpu.geometry import lie as jlie
from mam3slam_tpu.parallel import dist_ba as jdb
from mam3slam_tpu.parallel import dist_window_ba as jdwb
from mam3slam_tpu.solvers import ba as jba
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.parallel import dist_window_ba as tdwb
from mam3slam_tpu_torch.parallel import mesh as tmesh
from mam3slam_tpu_torch.solvers import ba as tba
from mam3slam_tpu_torch.solvers import ba_window as tbw
from test_ba import CAM_PARAMS, _build_problem, _reproj_rms, make_scene
import torch_dist_ranks

PIN = 0          # cameras.PINHOLE
N_CAMS, N_PTS, N_AGENTS = 6, 252, 8
ITERS = 10
DEADLINE_S = 180


def _scene():
    q, t, pts, oc, op, ouv = make_scene(n_cams=N_CAMS, n_pts=N_PTS,
                                        noise_px=0.5, seed=7)
    rng = np.random.default_rng(0)
    qp, tp = q.copy(), t.copy()
    tp[2:] += rng.normal(0, 0.05, tp[2:].shape)
    ptsp = (pts + rng.normal(0, 0.08, pts.shape)).astype(np.float32)
    cam_free = np.array([False, False] + [True] * (N_CAMS - 2))
    edge = _build_problem(qp, tp, ptsp, oc, op, ouv, cam_free,
                          np.ones(N_PTS, bool))
    window = (qp, tp, np.broadcast_to(CAM_PARAMS, (N_CAMS, 8)), ptsp, oc,
              op, ouv, np.ones(len(oc), np.float32), cam_free,
              np.ones(N_PTS, bool))
    return edge, window, (oc, op, ouv), (q, t)


def _pose_args():
    scenes = [make_scene(n_cams=1, n_pts=150, noise_px=0.4, seed=100 + i)
              for i in range(N_AGENTS)]
    M = min(min(len(s[4]) for s in scenes), 256)
    dq = np.asarray(jlie.so3_exp_quat(jnp.asarray([0.02, -0.01, 0.02])))
    qs, ts, pts, uvs = [], [], [], []
    for q, t, p, oc, op, ouv in scenes:
        qs.append(np.asarray(jlie.quat_mul(jnp.asarray(dq),
                                           jnp.asarray(q[0]))))
        ts.append(t[0] + np.array([0.05, -0.04, 0.06], np.float32))
        pts.append(p[op[:M]])
        uvs.append(ouv[:M])
    args = (np.stack(qs), np.stack(ts),
            np.broadcast_to(CAM_PARAMS, (N_AGENTS, 8)).copy(),
            np.stack(pts), np.stack(uvs),
            np.ones((N_AGENTS, M), np.float32), np.ones((N_AGENTS, M), bool))
    return args, np.stack([s[1][0] for s in scenes]), M


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    edge, window, obs, truth = _scene()
    pose_np, t_true, M = _pose_args()
    jwin = jdwb.window_problem_from_edges(*window)
    tedge = convert.ba_problem_from_numpy(jax.tree.map(np.asarray, edge),
                                          "cpu")
    twin = tdwb.window_problem_from_edges(*window, device="cpu")
    tpose = tuple(torch.from_numpy(np.ascontiguousarray(x))
                  for x in pose_np)

    # the port's spawned worlds run beside the reference's compiles
    worlds = (("w4", (4,), ("shard",), "shard", "shard",
               ("run_ba", "dense", "psum", "cg")),
              ("w2", (2,), ("shard",), "shard", "shard",
               ("solve_dense", "solve_psum")),
              ("w22", (2, 2), ("host", "chip"), "chip", "host",
               ("dense", "psum")))
    with concurrent.futures.ThreadPoolExecutor(len(worlds)) as pool:
        futures = {key: pool.submit(
            tmesh.run_ranks, torch_dist_ranks.solvers, shape, names,
            str(tmp_path_factory.mktemp(key)),
            (solvers, axis, pose_axis, PIN, tedge, twin, tpose, ITERS),
            backend="gloo", device="cpu", deadline_s=DEADLINE_S)
            for key, shape, names, axis, pose_axis, solvers in worlds}

        # the reference: meshes of 4 and (2, 2) virtual devices and the
        # unsharded pose vmap
        m4 = _jmesh((4,), ("shard",))
        m22 = _jmesh((2, 2), ("host", "chip"))
        ref = dict(
            run_ba=jax.jit(lambda p: jdb.dist_run_ba(
                p, _jmesh((4,), ("edge",)), PIN, iters=ITERS,
                cg_iters=30))(edge),
            pose=jdb.batched_pose_optimization(
                _jmesh((4,), ("agent",)), PIN)(*pose_np),
            dense=jdwb.dist_run_window_ba_dense(jwin, m4, PIN, iters=ITERS),
            psum=jdwb.dist_run_window_ba_psum(jwin, m4, PIN, iters=ITERS,
                                              cg_iters=30),
            cg=jdwb.dist_run_window_ba(jwin, m4, PIN, iters=ITERS,
                                       cg_iters=30),
            dense22=jdwb.dist_run_window_ba_dense(jwin, m22, PIN,
                                                  axis="chip", iters=ITERS),
            pose_vmap=jax.vmap(lambda q0, t0, cp, p, uv, w, v: jba.
                               pose_optimization(q0, t0, cp, PIN, p, uv, w,
                                                 v, use_pallas=False))(
                *pose_np))
        ref = jax.tree.map(np.asarray, ref)

        # the port on one device and on a world of 1 in this process
        local = convert.to_numpy(dict(
            run_ba=tba.run_ba(tedge, PIN, iters=ITERS, cg_iters=30),
            dense=tbw.run_window_ba_dense(twin, PIN, iters=ITERS),
            cg=tbw.run_window_ba(twin, PIN, iters=ITERS, cg_iters=30)))
        store = tmp_path_factory.mktemp("world1")
        mesh1 = tmesh.init_mesh((1,), ("shard",), "gloo",
                                f"file://{store}/store", device="cpu")
        try:
            world1 = torch_dist_ranks.solvers(
                mesh1, ("dense", "psum"), "shard", "shard", PIN, tedge,
                twin, tpose, ITERS)
        finally:
            tmesh.close_mesh()
        worlds = {key: f.result() for key, f in futures.items()}
    return dict(ref=ref, local=local, world1=world1, obs=obs, truth=truth,
                t_true=t_true, M=M, **worlds)


def _close(a, b, atol, n=N_CAMS):
    np.testing.assert_allclose(np.asarray(a)[:n], np.asarray(b)[:n],
                               atol=atol)


def _inlier_apart(a, b):
    a, b = np.asarray(a)[:N_PTS], np.asarray(b)[:N_PTS]
    return (a != b).mean()


def test_every_rank_holds_the_same_result(case):
    """The replicated outputs are equal bit for bit on every rank."""
    for key in ("w4", "w2", "w22"):
        ranks = case[key]
        assert len(ranks) == (2 if key == "w2" else 4)
        for other in ranks[1:]:
            for name in ranks[0]:
                if name in ("rank", "size"):
                    continue
                for a, b in zip(ranks[0][name], other[name]):
                    np.testing.assert_array_equal(a, b, err_msg=name)
        assert [r["rank"] for r in ranks] == (
            [0, 1] if key == "w2" else [0, 1, 2, 3] if key == "w4"
            else [0, 1, 0, 1])


def test_dist_run_ba_matches_reference_and_local(case):
    """Edges sharded over 4 ranks (tests/test_dist_ba.py:24): the cameras
    within 5e-3 of the reference on 4 devices and of the port's
    ``run_ba``, the reprojection RMS under 0.8 px and within 0.05 px."""
    got = case["w4"][0]["run_ba"]
    _close(got.cam_t, case["ref"]["run_ba"].cam_t, 5e-3)
    _close(got.cam_t, case["local"]["run_ba"].cam_t, 5e-3)
    rms_d, _ = _reproj_rms(got, *case["obs"])
    rms_l, _ = _reproj_rms(case["local"]["run_ba"], *case["obs"])
    assert rms_d < 0.8, rms_d
    assert abs(rms_d - rms_l) < 0.05
    assert abs(float(got.cost) - float(case["ref"]["run_ba"].cost)) \
        < 1e-3 * float(got.cost)


def test_batched_pose_matches_reference(case):
    """Eight agents over 4 ranks and over the "host" axis of (2, 2): the
    poses within 1e-4 of the reference's sharded and unsharded solves,
    each within 2 cm of the truth with > 90% of the edges inliers."""
    M = case["M"]
    for key in ("w4", "w22", "w2"):
        got = case[key][0]["pose"]
        np.testing.assert_allclose(got.t, case["ref"]["pose"].t, atol=1e-4)
        np.testing.assert_allclose(got.t, case["ref"]["pose_vmap"].t,
                                   atol=1e-4)
        assert (np.linalg.norm(got.t - case["t_true"], axis=1)
                < 0.02).all()
        assert (got.n_inliers > 0.9 * M).all()
        np.testing.assert_array_equal(got.n_inliers, got.inlier.sum(1))


def test_dist_window_ba_cg_matches(case):
    """The camera-sharded PCG on 4 ranks (tests/test_dist_ba.py:79):
    within 5e-3 of the reference on 4 devices and of the port's
    ``run_window_ba``."""
    got = case["w4"][0]["cg"]
    _close(got.cam_t, case["ref"]["cg"].cam_t, 5e-3)
    _close(got.cam_t, case["local"]["cg"].cam_t, 5e-3)
    np.testing.assert_allclose(got.pts[:N_PTS], case["ref"]["cg"].pts[:N_PTS],
                               atol=2e-2)
    assert _inlier_apart(got.pm_inlier, case["ref"]["cg"].pm_inlier) < 0.02


@pytest.mark.parametrize("key", ["world1", "w4", "w22"])
def test_dist_window_ba_dense_matches(case, key):
    """The one-all-reduce dense solver (tests/test_dist_ba.py:139, and on
    the "chip" axis tests/test_two_level_mesh.py:53): cameras within 5e-3
    and points within 2e-2 of the port's ``run_window_ba_dense`` and of
    the reference's dense solver on a mesh of the same size, inliers
    under 2% apart; on a world of 1 it is the single-device solver bit
    for bit."""
    got = case[key] if key == "world1" else case[key][0]
    got = got["dense"]
    loc = case["local"]["dense"]
    ref = case["ref"]["dense22" if key == "w22" else "dense"]
    for want in (loc, ref):
        _close(got.cam_t, want.cam_t, 5e-3)
        np.testing.assert_allclose(got.pts[:N_PTS], want.pts[:N_PTS],
                                   atol=2e-2)
        assert _inlier_apart(got.pm_inlier, want.pm_inlier) < 0.02
    if key == "world1":
        np.testing.assert_array_equal(got.cam_t, loc.cam_t)
        np.testing.assert_array_equal(got.pts, loc.pts)
    rms, _ = _reproj_rms(got, *case["obs"])
    assert rms < 0.8, rms


@pytest.mark.parametrize("key", ["world1", "w4", "w22"])
def test_dist_window_ba_psum_matches(case, key):
    """The owner-partitioned psum-CG solver at 1 and 4 ranks and on the
    "chip" axis (tests/test_dist_ba.py:175, test_two_level_mesh.py:53):
    cameras within 5e-3 and points within 2e-2 of the port's
    ``run_window_ba`` (points restored to their order through the shard
    permutation), within 2e-2 of the reference's psum solver on 4
    devices; inliers under 2% apart."""
    got = (case[key] if key == "world1" else case[key][0])["psum"]
    loc = case["local"]["cg"]
    _close(got.cam_t, loc.cam_t, 5e-3)
    np.testing.assert_allclose(got.pts, loc.pts[:N_PTS], atol=2e-2)
    assert got.pts.shape == (N_PTS, 3)
    assert _inlier_apart(got.pm_inlier, loc.pm_inlier) < 0.02
    _close(got.cam_t, case["ref"]["psum"].cam_t, 2e-2)
    rms, _ = _reproj_rms(got, *case["obs"])
    assert rms < 0.8, rms


def test_dist_solve_dispatcher(case):
    """4 free cameras over 2 ranks: the dispatcher takes the dense solver
    at the default cap (within 5e-3 of the dense solver, as on a world of
    1) and the psum-CG one at cap 0 (within 5e-3 of ``run_window_ba``),
    the two within 5e-3 of each other (tests/test_dist_ba.py:244)."""
    r = case["w2"][0]
    _close(r["solve_dense"].cam_t, case["world1"]["dense"].cam_t, 5e-3)
    _close(r["solve_dense"].cam_t, case["local"]["dense"].cam_t, 5e-3)
    _close(r["solve_psum"].cam_t, case["local"]["cg"].cam_t, 5e-3)
    _close(r["solve_psum"].cam_t, r["solve_dense"].cam_t, 5e-3)
    np.testing.assert_allclose(r["solve_psum"].pts,
                               case["local"]["cg"].pts[:N_PTS], atol=2e-2)


def test_compact_free_layout_and_solution():
    """``compact_free`` (tests/test_dist_ba.py:212): both packages build
    the same layout field for field, with and without it; the compact
    problem's camera block is the free cameras in order, and it solves to
    the full layout's poses within 1e-4 and points within 1e-3."""
    _, window, _, _ = _scene()
    for compact in (False, True):
        ref = jdwb.window_problem_from_edges(*window, compact_free=compact)
        got = tdwb.window_problem_from_edges(*window, compact_free=compact,
                                             device="cpu")
        for f in ref._fields:
            a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    full = tdwb.window_problem_from_edges(*window, device="cpu")
    free = np.flatnonzero(window[8])
    assert got.cam_q.shape[0] == len(free)
    np.testing.assert_array_equal(got.cam_idx.numpy(), free)
    rf = tbw.run_window_ba_dense(full, PIN, iters=ITERS)
    rc = tbw.run_window_ba_dense(got, PIN, iters=ITERS)
    np.testing.assert_allclose(rc.cam_t.numpy(), rf.cam_t.numpy()[free],
                               atol=1e-4)
    np.testing.assert_allclose(rc.pts.numpy(), rf.pts.numpy(), atol=1e-3)


def test_pad_and_shard_match_reference():
    """``pad_problem`` and ``shard_problem_for_psum`` lay a problem out as
    the reference does (every field, and the point order restored)."""
    _, window, _, _ = _scene()
    ref = jdwb.window_problem_from_edges(*window)
    got = tdwb.window_problem_from_edges(*window, device="cpu")
    for n in (4, 5):
        pr, pg = jdwb.pad_problem(ref, n), tdwb.pad_problem(got, n)
        for f in pr._fields:
            np.testing.assert_array_equal(np.asarray(getattr(pr, f)),
                                          getattr(pg, f).numpy(), err_msg=f)
        (sr, ir), (sg, ig) = (jdwb.shard_problem_for_psum(ref, n),
                              tdwb.shard_problem_for_psum(got, n))
        for f in sr._fields:
            np.testing.assert_array_equal(np.asarray(getattr(sr, f)),
                                          getattr(sg, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(np.asarray(ir), ig.numpy())


def test_a_failing_rank_fails_the_run_at_once(tmp_path):
    """Rank 2 of 4 raises while the others wait in a collective it never
    joins: ``run_ranks`` stops them and raises with its traceback long
    before the collectives' own timeout (120 s)."""
    t0 = time.monotonic()
    with pytest.raises(tmesh.RankFailed, match="rank fault"):
        tmesh.run_ranks(torch_dist_ranks.failing, (4,), ("shard",),
                        str(tmp_path), (2, 600.0), backend="gloo",
                        device="cpu", deadline_s=DEADLINE_S)
    assert time.monotonic() - t0 < 60
