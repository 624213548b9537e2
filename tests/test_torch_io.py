"""Port parity of the host I/O: settings (mam3slam_tpu_torch.io.settings,
which reads the YAML dialect itself) against the reference's
``yaml.safe_load`` reader, the DBoW2 text vocabulary both ways across the
packages, ``default_vocabulary``, and every artifact writer fed the same
run's state in both packages.  Strings, integers and timestamps must be
identical, poses within 1e-5."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mam3slam_tpu.io import render as jrender
from mam3slam_tpu.io import settings as JS
from mam3slam_tpu.io import writers as JW
from mam3slam_tpu.ops import bow as jbow
from mam3slam_tpu_torch import convert
from mam3slam_tpu_torch.geometry import cameras as tcam
from mam3slam_tpu_torch.io import settings as TS
from mam3slam_tpu_torch.io import writers as TW
from mam3slam_tpu_torch.ops import bow as tbow
from mam3slam_tpu_torch.slam import system as tsys
from test_io_api import PINHOLE_YAML
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401


def _kb8_yaml(cam) -> str:
    """The reference fixture's values at ``cam`` (bench.py's KB8 yaml)."""
    return f"""%YAML:1.0
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: {cam.fx}
Camera1.fy: {cam.fy}
Camera1.cx: {cam.cx}
Camera1.cy: {cam.cy}
Camera1.k1: {cam.k[0]}
Camera1.k2: {cam.k[1]}
Camera1.k3: {cam.k[2]}
Camera1.k4: {cam.k[3]}
Camera.width: {cam.width}
Camera.height: {cam.height}
Camera.fps: 20
ORBextractor.nFeatures: 700
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


SETTINGS_FILES = {
    "pinhole": PINHOLE_YAML,
    "kb8_fixture_960": _kb8_yaml(jrender.reference_kb8_cam(1.0)),
    "kb8_fixture_720": _kb8_yaml(jrender.reference_kb8_cam(0.75)),
    # a resize, a comment, an exponent without a dot (a string to
    # safe_load, converted by float()), an unquoted camera type, atlas
    # keys, a boolean and an empty value
    "resize_and_dialect": PINHOLE_YAML.replace(
        "Camera.fps: 20", "Camera.fps: 20.0   # Hz\nCamera.newWidth: 564\n"
        "Camera.newHeight: 360\nSystem.SaveAtlasToFile: 'atlas.osa'\n"
        "Viewer.on: yes\nViewer.empty:\nCamera1.k3: 1e-5").replace(
            '"PinHole"', "PinHole"),
    "rectified": PINHOLE_YAML.replace('"PinHole"', '"Rectified"'),
}


@pytest.mark.parametrize("name", sorted(SETTINGS_FILES))
def test_load_settings_matches_reference(tmp_path, name):
    p = tmp_path / "cam.yaml"
    p.write_text(SETTINGS_FILES[name])
    ref = JS.load_settings(str(p))
    got = TS.load_settings(str(p))
    for f in ref.__dataclass_fields__:
        a, b = getattr(ref, f), getattr(got, f)
        assert type(a) is type(b) and a == b, (f, a, b)
    assert (got.eff_width, got.eff_height) == (ref.eff_width, ref.eff_height)
    rc, gc = ref.camera(), got.camera("cpu")
    assert rc.kind == gc.kind
    np.testing.assert_array_equal(gc.params.numpy(), np.asarray(rc.params))


def test_settings_types_follow_safe_load():
    """Each plain scalar gets the type and value ``yaml.safe_load`` gives
    it (YAML 1.1): the gates of load_settings depend on them."""
    import yaml

    values = ["1", "1.0", "1e-5", "1.0e-5", "1.0e+5", "1.", ".5", "-.5",
              "+1.5", "0", "007", "0x1F", "0b101", "1_000", "1:30", ".inf",
              "-.Inf", "yes", "No", "on", "OFF", "~", "null", "abc",
              "0.0000176187114", "-0.28340811", '"1.0"', "'it''s'",
              '"a\\tb # c"', "3 # comment", ""]
    for v in values:
        ref = yaml.safe_load(f"k: {v}")["k"]
        got = TS.parse_filestorage_yaml(f"%YAML:1.0\nk: {v}\n")["k"]
        assert type(got) is type(ref) and got == ref, (v, ref, got)
    # beyond the flat dialect (sub-mappings, sequences, OpenCV matrix
    # tags) the port refuses the file
    for text in ("S:\n  b: 1\n", "k: [1, 2]\n", "T: !!opencv-matrix\n",
                 "- 1\n"):
        with pytest.raises(TS.SettingsError):
            TS.parse_filestorage_yaml(text)


def test_settings_version_gate(tmp_path):
    """No version tag, or an unquoted 1.0 (a float to safe_load): both
    packages refuse the file."""
    for text in (PINHOLE_YAML.replace('File.version: "1.0"', ""),
                 PINHOLE_YAML.replace('"1.0"', "1.0")):
        p = tmp_path / "bad.yaml"
        p.write_text(text)
        with pytest.raises(JS.SettingsError):
            JS.load_settings(str(p))
        with pytest.raises(TS.SettingsError):
            TS.load_settings(str(p))


def _quantize_ref(voc, desc):
    bits = jnp.asarray(np.unpackbits(desc, axis=-1, bitorder="little")
                       .astype(np.float32))
    return np.asarray(jbow.quantize(voc, bits))


def test_orbvoc_text_round_trip_across_packages(tmp_path):
    """A vocabulary built in the test, written by each package and read by
    the other: identical files, words and idf."""
    descs = np.random.default_rng(7).integers(0, 256, (3000, 32),
                                              dtype=np.uint8)
    tvoc = tbow.build_vocabulary(descs, k=4, depth=3, iters=3)
    jvoc = jbow.build_vocabulary(descs, k=4, depth=3, iters=3)
    tp, jp = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tbow.save_orbvoc_text(tvoc, tp)
    jbow.save_orbvoc_text(jvoc, jp)
    assert open(tp).read() == open(jp).read()
    from_j = tbow.load_orbvoc_text(jp)       # port reads the reference's
    from_t = jbow.load_orbvoc_text(tp)       # reference reads the port's
    q = descs[:500]
    words = tbow.quantize(tvoc, torch.tensor(q)).numpy()
    np.testing.assert_array_equal(
        tbow.quantize(from_j, torch.tensor(q)).numpy(), words)
    np.testing.assert_array_equal(_quantize_ref(from_t, q), words)
    np.testing.assert_allclose(from_j.idf.numpy(), tvoc.idf.numpy(),
                               rtol=1e-5)
    # an imported tree carries its leaf map, as the reference's does
    np.testing.assert_array_equal(from_j.leaf_map.numpy(),
                                  np.asarray(from_t.leaf_map))
    for a, b in zip(from_j.centroid_bits, from_t.centroid_bits):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tbow.save_orbvoc_text(from_j, str(tmp_path / "x.txt"))


def test_orbvoc_incomplete_tree_matches_reference(tmp_path):
    """An irregular DBoW2 tree (a parent with fewer than k children, a
    leaf above the bottom level; tests/test_vocab_scale.py's): both
    packages import the same padded levels, leaf map and idf, and
    quantize alike."""
    rng = np.random.default_rng(11)
    d = [rng.integers(0, 256, 32, dtype=np.uint8) for _ in range(8)]
    nodes = [(0, 0, d[0], 0.0), (0, 1, d[1], 0.5), (0, 0, d[2], 0.0),
             (1, 1, d[3], 0.7), (1, 1, d[4], 0.9), (1, 1, d[5], 0.3),
             (3, 1, d[6], 0.4), (3, 1, d[7], 0.8)]
    path = str(tmp_path / "irr.txt")
    with open(path, "w") as f:
        f.write("3 2 0 0\n" + "".join(
            f"{p} {leaf} {' '.join(str(int(v)) for v in desc)} {w}\n"
            for p, leaf, desc, w in nodes))
    got, ref = tbow.load_orbvoc_text(path), jbow.load_orbvoc_text(path)
    assert (got.k, got.depth, got.n_words) == (ref.k, ref.depth, 6)
    for a, b in zip(got.centroid_bits, ref.centroid_bits):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.leaf_map.numpy(),
                                  np.asarray(ref.leaf_map))
    np.testing.assert_array_equal(got.idf.numpy(), np.asarray(ref.idf))
    q = rng.integers(0, 256, (300, 32), dtype=np.uint8)
    np.testing.assert_array_equal(tbow.quantize(got, torch.tensor(q)).numpy(),
                                  _quantize_ref(ref, q))


def test_default_vocabulary_env(tmp_path, monkeypatch):
    """$MAM3_VOCAB names the file; unset, the repository's data/ORBvoc.txt
    (absent here) gives None; a path-keyed cache picks up a file set
    after a miss."""
    repo_voc = os.path.join(os.path.dirname(tbow.__file__), "..", "..",
                            "data", "ORBvoc.txt")
    monkeypatch.delenv("MAM3_VOCAB", raising=False)
    assert (tbow.default_vocabulary() is None) == (not os.path.exists(
        repo_voc))
    descs = np.random.default_rng(3).integers(0, 256, (800, 32),
                                              dtype=np.uint8)
    path = str(tmp_path / "voc.txt")
    monkeypatch.setenv("MAM3_VOCAB", path)
    assert tbow.default_vocabulary() is None          # not written yet
    tbow.save_orbvoc_text(tbow.build_vocabulary(descs, k=3, depth=2), path)
    voc = tbow.default_vocabulary()
    assert voc is not None and voc.k == 3 and voc.depth == 2
    assert tbow.default_vocabulary() is voc           # cached
    ref = jbow.load_orbvoc_text(path)
    np.testing.assert_array_equal(
        tbow.quantize(voc, torch.tensor(descs)).numpy(),
        _quantize_ref(ref, descs))


# ---------------------------------------------------------------------------
# writers: one reference run's state through both packages' writers
# ---------------------------------------------------------------------------

class _Server:
    def __init__(self, events, timers):
        self.events, self.timers = events, timers


@pytest.fixture(scope="module")
def twin_systems():
    """A reference SlamSystem run on the synthetic world
    (tests/test_slam_e2e.py), and a port SlamSystem holding the same map
    (carried over by convert.map_state_from_numpy), trajectories, events,
    culled-keyframe table and timers.  A keyframe that trajectory rows
    name is culled in both, some frames are marked lost, and the event
    lists gain a NEWMAP, a RELOC and a MERGE."""
    from test_slam_e2e import run_slam

    jsys, aid, _, _ = run_slam(n_frames=30, seed=7)
    traj = jsys.agents[aid].trajectory
    refs = sorted({r[1] for r in traj if r[1] > 0})
    culled = refs[0]
    parent = refs[1] if len(refs) > 1 else 0
    q_cp = np.asarray([0.9998, 0.01, -0.01, 0.0125], np.float32)
    q_cp /= np.linalg.norm(q_cp)
    t_cp = np.asarray([0.05, -0.02, 0.1], np.float32)
    jsys.culled_kf[culled] = (parent, q_cp, t_cp)
    # the earliest keyframe moves to map 1: the KITTI origin still is it
    k0 = int(np.argmin(np.where(np.asarray(jsys.ms.kf_valid),
                                np.asarray(jsys.ms.kf_ts), np.inf)))
    jsys.ms = jsys.ms._replace(
        kf_valid=jsys.ms.kf_valid.at[culled].set(False),
        kf_map=jsys.ms.kf_map.at[k0].set(1))
    for i in (12, 13, 20):   # lost frames
        traj[i] = traj[i][:4] + (3,)
    jsys.events += ["NEWMAP agent=0 map=1",
                    "RELOC agent=0 kf=3 map 1 -> 0"]
    jsrv = _Server(["MERGE agent=0 map 1 -> 0 kf=4 ts=12.5"], jsys.timers)

    cfg = tsys.SlamConfig(**{f: getattr(jsys.cfg, f)
                             for f in tsys.SlamConfig.__dataclass_fields__})
    tcam_ = tcam.make_pinhole(*np.asarray(jsys.cam.params)[:4], device="cpu")
    psys = tsys.SlamSystem(cfg, tcam_)
    psys.ms = convert.map_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jsys.ms), device="cpu")
    psys.add_agent()
    psys.agents[0].map_id = jsys.agents[aid].map_id
    psys.agents[0].trajectory = [
        (ts, ref, np.asarray(q), np.asarray(t), st)
        for ts, ref, q, t, st in traj]
    psys.agents[0].times_ms = list(jsys.agents[aid].times_ms)
    psys.events = list(jsys.events)
    psys.culled_kf = dict(jsys.culled_kf)
    psys.timers.series.update(jsys.timers.series)
    psrv = _Server(list(jsrv.events), psys.timers)
    return jsys, jsrv, psys, psrv


def _rows(path):
    with open(path) as f:
        return [line.split() for line in f]


def _compare_files(ref_path, got_path, pose_cols=(), int_cols=None):
    """Row by row: columns in ``pose_cols`` within 1e-5, the rest
    identical text."""
    ref, got = _rows(ref_path), _rows(got_path)
    assert len(ref) == len(got), (ref_path, len(ref), len(got))
    for r, g in zip(ref, got):
        assert len(r) == len(g)
        for c, (a, b) in enumerate(zip(r, g)):
            if c in pose_cols and not a.isalpha():
                assert abs(float(a) - float(b)) <= 1e-5, (ref_path, r, g)
            else:
                assert a == b, (ref_path, c, r, g)


def test_writers_artifact_set_matches_reference(tmp_path, twin_systems):
    jsys, jsrv, psys, psrv = twin_systems
    JW.save_all(jsys, jsrv, str(tmp_path / "ref"))
    TW.save_all(psys, psrv, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    pose = {"Trajectory_0.txt": range(1, 8), "KF_traj.txt": range(1, 8)}
    for name in names:
        _compare_files(tmp_path / "ref" / name, tmp_path / "port" / name,
                       pose_cols=pose.get(name, ()))
    for name in ("Trajectory_0.txt", "KF_traj.txt", "MapLogs.txt",
                 "TrackingStatus_0.txt", "TimesT_0.txt", "TimesLM_0.txt",
                 "reloc.txt"):
        assert _rows(tmp_path / "port" / name), name
    rows = _rows(tmp_path / "port" / "Trajectory_0.txt")[1:]
    # lost frames are skipped; the culled reference resolves to a live KF
    assert len(rows) == sum(r[4] == 2 for r in psys.agents[0].trajectory)
    q = np.asarray([[float(v) for v in r[4:8]] for r in rows])
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-5)
    assert "Merge of map 1 into 0" in open(
        tmp_path / "port" / "MapLogs.txt").read()
    # the reference's fault, kept: reloc.txt takes tokens 3 and 5 of
    # "RELOC agent=0 kf=3 map 1 -> 0", which are "map" and "->"
    assert _rows(tmp_path / "port" / "reloc.txt") == [["0.000000", "map",
                                                       "->"]]


def test_writers_legacy_formats_match_reference(tmp_path, twin_systems):
    """TUM, per-map TUM keyframes and KITTI rows, with the reference's
    three faults kept: KITTI drops the lost frames (3 here), TUM keeps
    the world frame (no first-KF origin), the KITTI origin is the
    earliest keyframe over all maps."""
    jsys, _, psys, _ = twin_systems
    for fn, args in ((JW.save_trajectory_tum, (0,)),
                     (JW.save_kf_trajectory_tum, ()),
                     (JW.save_trajectory_kitti, (0,))):
        tfn = getattr(TW, fn.__name__)
        fn(jsys, *args, str(tmp_path / f"ref_{fn.__name__}.txt"))
        tfn(psys, *args, str(tmp_path / f"port_{fn.__name__}.txt"))
        n = 12 if "kitti" in fn.__name__ else 8
        _compare_files(tmp_path / f"ref_{fn.__name__}.txt",
                       tmp_path / f"port_{fn.__name__}.txt",
                       pose_cols=range(n) if n == 12 else range(1, 8))
    JW.save_kf_trajectory_tum(jsys, str(tmp_path / "r_map.txt"), map_id=0)
    TW.save_kf_trajectory_tum(psys, str(tmp_path / "p_map.txt"), map_id=0)
    _compare_files(tmp_path / "r_map.txt", tmp_path / "p_map.txt",
                   pose_cols=range(1, 8))
    traj = psys.agents[0].trajectory
    kitti = _rows(tmp_path / "port_save_trajectory_kitti.txt")
    assert len(kitti) == sum(r[4] == 2 for r in traj) == len(traj) - 3
    # TUM rows are world-frame poses: the first row is the frame's Twc
    tum = _rows(tmp_path / "port_save_trajectory_tum.txt")
    first_ok = next(r for r in psys.trajectory_world(0) if r[3] == 2)
    np.testing.assert_allclose([float(v) for v in tum[0][1:4]],
                               first_ok[2], atol=1e-5)
    # the KITTI origin: the earliest live keyframe of all maps (in map 1,
    # not the agent's map 0)
    ms = psys.ms
    live = np.where(ms.kf_valid.numpy())[0]
    k0 = live[np.argmin(ms.kf_ts.numpy()[live])]
    assert int(ms.kf_map[k0]) == 1 and psys.agents[0].map_id == 0
    R0 = tcam_matrix(ms.kf_q[k0]).T          # R_wc of k0
    t0 = -R0 @ ms.kf_t[k0].numpy()
    t_0c = R0.T @ (np.asarray(first_ok[2]) - t0)
    np.testing.assert_allclose([float(kitti[0][i]) for i in (3, 7, 11)],
                               t_0c, atol=1e-5)


def tcam_matrix(q) -> np.ndarray:
    from mam3slam_tpu_torch.geometry import lie
    return lie.quat_to_matrix(q).numpy().astype(np.float64)


def test_ate_rmse_matches_reference():
    rng = np.random.default_rng(2)
    gt = rng.normal(0, 1, (50, 3))
    est = 0.7 * gt @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.3
    est += rng.normal(0, 0.01, est.shape)
    for s in (True, False):
        assert TW.ate_rmse(est, gt, s) == JW.ate_rmse(est, gt, s)
