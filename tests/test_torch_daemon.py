"""Port twins of tests/test_daemon.py (frame ingestion across a real
socket and a watched directory, the live MJPEG and map views, the
interactive page and its JSON snapshot) on the port's SlamSystem, and
the port's own image codecs (mam3slam_tpu_torch.io.images): its JPEG
encoder decoded by cv2 and PIL against cv2's own quality-80 encode, and
its PNG reader against ``cv2.imread(..., IMREAD_GRAYSCALE)``."""

import io
import json
import socket
import struct
import threading
import time
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from mam3slam_tpu.io import daemon as jdaemon
from mam3slam_tpu_torch.geometry import cameras
from mam3slam_tpu_torch.io import euroc, images, render, viewer
from mam3slam_tpu_torch.io.daemon import (FrameIngestServer, MjpegServer,
                                          send_frame, watch_directory)
from mam3slam_tpu_torch.io.stream import LatestFrameBuffer
from mam3slam_tpu_torch.slam.system import OK, SlamConfig, SlamSystem
from test_slam_e2e import (CX, CY, FX, FY, H, N_FEAT, W, SyntheticWorld,
                           make_trajectory)
from test_torch_server_e2e import port_frame
from test_torch_server_e2e import torch_threads_per_worker  # noqa: F401


def _make_frames(n=40):
    world = SyntheticWorld(n_mp=600, seed=2)
    traj = make_trajectory(n)
    return [(i / 20.0, port_frame(world, R, t))
            for i, (R, t) in enumerate(traj)]


def _system():
    """tests/test_daemon.py's tracking system, on the port."""
    cfg = SlamConfig(width=W, height=H, n_feat=N_FEAT, max_kf=64,
                     max_mp=4096, n_levels=4, min_init_matches=60)
    return SlamSystem(cfg, cameras.make_pinhole(FX, FY, CX, CY,
                                                device="cpu"))


def _tiny_system():
    cfg = SlamConfig(width=64, height=64, n_feat=64, max_kf=8, max_mp=256,
                     n_levels=2)
    return SlamSystem(cfg, cameras.make_pinhole(40.0, 40.0, 32.0, 32.0,
                                                device="cpu"))


def _http_get(port, path):
    data = b""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as sock:
        sock.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        try:
            while True:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                data += chunk
        except socket.timeout:
            pass
    return data


def _read_stream(port, path, n_images=2):
    data = b""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as sock:
        sock.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
        t0 = time.time()
        while data.count(b"\xff\xd8") < n_images and time.time() - t0 < 5.0:
            chunk = sock.recv(65536)
            if not chunk:
                break
            data += chunk
    return data


def _pump(srv, key, img):
    """Publish ``img`` rolled one column per 20 ms until stopped."""
    stop = threading.Event()

    def run():
        i = 0
        while not stop.is_set():
            srv.publish(key, np.roll(img, i, axis=1))
            i += 1
            time.sleep(0.02)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return stop, th


def test_tcp_ingest_tracks_end_to_end():
    """A separate 'camera process' (a socket client thread) feeds frames
    over TCP byte-exactly; the daemon side tracks through the system."""
    frames = _make_frames(40)
    sys_ = _system()
    aid = sys_.add_agent()
    buf = LatestFrameBuffer()
    srv = FrameIngestServer({aid: buf})
    sent = []

    def client():
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=5) as sock:
            rng = np.random.default_rng(0)
            for i in range(12):
                img = rng.integers(0, 255, (H, W), dtype=np.uint8)
                sent.append(img)
                send_frame(sock, aid, i / 20.0, img)
                time.sleep(0.02)

    th = threading.Thread(target=client)
    got = []
    try:
        th.start()
        while len(got) < 12:
            item = buf.take(timeout_s=5.0)
            if item is None:
                break
            got.append(item)
        th.join(timeout=10)
    finally:
        srv.close()
    assert len(got) >= 6  # slow-consumer drops allowed
    for ts, img in got:
        np.testing.assert_array_equal(img, sent[int(round(ts * 20))])
    assert buf.closed            # close() ends the streams
    states = [sys_.track(aid, f, ts)[0] for ts, f in frames]
    assert states[-1] == OK
    assert sys_.agents[aid].last_frame is frames[-1][1]
    assert sys_.agents[aid].last_feat_mp.shape == (N_FEAT,)


def test_tcp_ingest_hangs_up_on_an_oversized_header():
    """A header announcing more pixels than any camera sends closes the
    connection before any frame lands; other clients go on."""
    buf = LatestFrameBuffer()
    srv = FrameIngestServer({0: buf})
    try:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=5) as sock:
            sock.sendall(struct.pack("<IdII", 0, 0.0, 1 << 16, 1 << 16))
            assert sock.recv(1) == b""          # the server hung up
        assert buf.take(timeout_s=0.2) is None and buf.n_pushed == 0
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=5) as sock:
            send_frame(sock, 0, 0.5, np.full((4, 6), 7, np.uint8))
        ts, img = buf.take(timeout_s=5.0)
        assert ts == 0.5 and img.shape == (4, 6) and (img == 7).all()
    finally:
        srv.close()


def test_watch_directory_ingest(tmp_path):
    buf = LatestFrameBuffer()
    stop = threading.Event()
    th = watch_directory(str(tmp_path), {0: buf}, poll_s=0.02, stop=stop)
    try:
        rng = np.random.default_rng(1)
        imgs = []
        for i in range(5):
            img = rng.integers(0, 255, (48, 64), dtype=np.uint8)
            imgs.append(img)
            cv2.imwrite(str(tmp_path / f"agent0_{i / 20.0:.3f}.png"), img)
            item = buf.take(timeout_s=5.0)
            assert item is not None
            ts, got = item
            np.testing.assert_array_equal(got, imgs[int(round(ts * 20))])
        # a file still being written is left for the next poll
        data = images.encode_png(imgs[0])
        part = tmp_path / "agent0_9.000.png"
        part.write_bytes(data[:len(data) // 2])
        time.sleep(0.1)
        assert part.exists() and buf.take(timeout_s=0.05) is None
        part.write_bytes(data)
        ts, got = buf.take(timeout_s=5.0)
        assert ts == 9.0 and np.array_equal(got, imgs[0])
        open(tmp_path / "STOP", "w").close()
        t0 = time.time()
        while not buf.closed and time.time() - t0 < 5.0:
            time.sleep(0.02)
        assert buf.closed
    finally:
        stop.set()
        th.join(timeout=5)


def test_mjpeg_live_view():
    srv = MjpegServer(device="cpu")
    img = np.zeros((32, 48, 3), np.uint8)
    img[8:16, 8:16] = 255
    stop, th = _pump(srv, 0, img)
    try:
        data = _read_stream(srv.port, "/agent0")
    finally:
        stop.set()
        th.join(timeout=5)
        srv.close()
    assert b"multipart/x-mixed-replace" in data
    # at least two complete JPEGs streamed (SOI + EOI markers)
    assert data.count(b"\xff\xd8") >= 2
    assert b"\xff\xd9" in data
    # the index page lists the agent
    srv2 = MjpegServer(device="cpu")
    try:
        srv2.publish(0, img)
        page = _http_get(srv2.port, "/")
    finally:
        srv2.close()
    assert b"/agent0" in page


def test_mjpeg_map_view():
    """/map streams the live map image published under the "map" key
    (reference MapDrawer window, src/MapDrawer.cc:1-419)."""
    srv = MjpegServer(device="cpu")
    img = np.zeros((40, 60, 3), np.uint8)
    img[10:20, 10:20] = 200
    stop, th = _pump(srv, "map", img)
    try:
        data = _read_stream(srv.port, "/map")
    finally:
        stop.set()
        th.join(timeout=5)
        srv.close()
    assert b"multipart/x-mixed-replace" in data
    assert data.count(b"\xff\xd8") >= 2


def test_interactive_map3d_page_and_data():
    """/map3d serves the self-contained interactive viewer page and
    /mapdata the JSON snapshot it polls."""
    sys_ = _tiny_system()
    sys_.add_agent()
    snap = viewer.map_snapshot(sys_)
    json.dumps(snap)
    assert set(snap) >= {"points", "pmap", "segs", "scls", "span", "stats"}
    srv = MjpegServer(device="cpu")
    try:
        srv.publish_json("map", snap)
        page = _http_get(srv.port, "/map3d")
        assert b"200 OK" in page and b"text/html" in page
        # the reference's page, byte for byte
        assert page.split(b"\r\n\r\n", 1)[1] == jdaemon._MAP3D_HTML
        assert b"<canvas" in page and b"/mapdata" in page
        # fully self-contained: no external script/style references
        assert b"http://" not in page.split(b"\r\n\r\n", 1)[1]
        assert b"https://" not in page
        raw = _http_get(srv.port, "/mapdata")
        assert b"application/json" in raw
        parsed = json.loads(raw.split(b"\r\n\r\n", 1)[1])
        assert parsed["stats"]["agents"] == 1
        assert isinstance(parsed["points"], list)
        # the index page links the interactive view once data is published
        assert b"/map3d" in _http_get(srv.port, "/")
    finally:
        srv.close()


def test_map_snapshot_contents():
    """After a tracked sequence the snapshot carries points, KF frusta
    segments (8 per KF) and trajectory segments."""
    sys_ = _system()
    aid = sys_.add_agent()
    for ts, f in _make_frames(30):
        sys_.track(aid, f, ts)
    snap = viewer.map_snapshot(sys_)
    assert snap["stats"]["kfs"] >= 2 and snap["stats"]["mps"] > 50
    assert len(snap["points"]) == len(snap["pmap"])
    assert len(snap["segs"]) == len(snap["scls"])
    # every valid KF contributes 8 frustum segments (class 1)
    assert sum(1 for c in snap["scls"] if c == 1) == 8 * snap["stats"]["kfs"]
    # trajectory segments exist for agent 0 (class 2)
    assert any(c == 2 for c in snap["scls"])


def test_draw_map_image_shape():
    """draw_map_image returns a BGR u8 image of the map without touching
    the file system."""
    sys_ = _tiny_system()
    sys_.add_agent()
    img = viewer.draw_map_image(sys_)
    assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
    assert img.shape[0] > 100 and img.shape[1] > 100


# ---------------------------------------------------------------------------
# the port's codecs
# ---------------------------------------------------------------------------

def _annotated_room_frame():
    """A rendered room frame drawn over as the live view draws it:
    keypoint squares and dots, and the banner."""
    cam = render.RenderCam(width=320, height=240, fx=160.0, fy=160.0,
                           cx=160.0, cy=120.0)
    R, t, _ = render.orbit_trajectory(8, 0.0, 30.0, radius=2.5,
                                      bob=0.05)[5]
    gray = render.RoomScene(seed=1, device="cpu").render(R, t, cam)
    bgr = np.repeat(gray.numpy().astype(np.uint8)[..., None], 3, axis=2)
    rng = np.random.default_rng(4)
    for x, y in rng.integers(8, (312, 232), (60, 2)):
        cv2.rectangle(bgr, (int(x) - 3, int(y) - 3), (int(x) + 3, int(y) + 3),
                      (0, 200, 0), 1)
        cv2.circle(bgr, (int(x), int(y)), 1, (200, 120, 0), -1)
    bar = np.zeros((22, 320, 3), np.uint8)
    viewer.put_text(bar, "SLAM | agent 0 map 0 | KFs: 12  MPs: 3456", 6, 15,
                    (255, 255, 255))
    return np.concatenate([bgr, bar])


@pytest.mark.parametrize("colour", [True, False])
def test_jpeg_encoder_against_cv2(colour):
    img = _annotated_room_frame()
    if not colour:
        img = img[..., 1].copy()
    jpg = images.encode_jpeg(img)
    assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"
    sof = jpg.index(b"\xff\xc0")
    h, w, nc = struct.unpack(">HHB", jpg[sof + 5:sof + 10])
    assert (h, w, nc) == (img.shape[0], img.shape[1], 3 if colour else 1)
    ok, ref = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80])
    assert ok
    flag = cv2.IMREAD_COLOR if colour else cv2.IMREAD_GRAYSCALE
    ref_mae = np.abs(cv2.imdecode(ref, flag).astype(float) - img).mean()
    got = cv2.imdecode(np.frombuffer(jpg, np.uint8), flag)
    pil = np.asarray(Image.open(io.BytesIO(jpg)))
    if colour:
        pil = pil[..., ::-1]           # PIL decodes to RGB
    for dec in (got, pil):
        assert dec.shape == img.shape
        assert np.abs(dec.astype(float) - img).mean() <= ref_mae + 1.0
    assert len(jpg) <= 1.5 * len(ref)


def test_jpeg_encoder_odd_sizes_and_stuffing():
    """Sizes that are not multiples of 8, flat and saturated blocks
    (long zero runs, EOBs) and noise (0xFF bytes to stuff) decode, each
    within cv2's own quality-80 error + 1 grey level."""
    rng = np.random.default_rng(5)
    cases = [rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
             rng.integers(0, 256, (9, 17), dtype=np.uint8),
             np.zeros((16, 16), np.uint8), np.full((8, 24, 3), 255, np.uint8)]
    for img in cases:
        jpg = images.encode_jpeg(img)
        dec = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_UNCHANGED)
        assert dec is not None and dec.shape == img.shape
        ok, ref = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80])
        ref_mae = np.abs(cv2.imdecode(ref, cv2.IMREAD_UNCHANGED).astype(
            float) - img).mean()
        assert ok and np.abs(dec.astype(float) - img).mean() <= ref_mae + 1.0
    with pytest.raises(ValueError):
        images.encode_jpeg(np.zeros((8, 8), np.float32))
    torch_img = torch.as_tensor(cases[0])
    assert images.encode_jpeg(torch_img) == images.encode_jpeg(cases[0])


def _filtered_png(img: np.ndarray, ctype: int, filt) -> bytes:
    """A PNG of ``img`` [H, W, C] built by hand: every row filtered with
    ``filt(y)`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    rows = []
    for y in range(h):
        r = x[y]
        up = x[y - 1] if y else np.zeros_like(r)
        a = np.concatenate([np.zeros(c, np.int16), r[:-c]])
        cc = np.concatenate([np.zeros(c, np.int16), up[:-c]])
        f = filt(y)
        p = a + up - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - cc)
        pred = [0, a, up, (a + up) >> 1,
                np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, up, cc))][f]
        rows.append(np.concatenate([[f], (r - pred) & 255]).astype(np.uint8))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes()))
            + chunk(b"IEND", b""))


FILTERS = {"none": lambda y: 0, "sub": lambda y: 1, "up": lambda y: 2,
           "average": lambda y: 3, "paeth": lambda y: 4,
           "mixed": lambda y: y % 5}


@pytest.mark.parametrize("ctype,channels,tol",
                         [(0, 1, 0), (2, 3, 1), (6, 4, 1)])
def test_png_decoder_filters_against_cv2(tmp_path, ctype, channels, tol):
    rng = np.random.default_rng(ctype)
    img = rng.integers(0, 256, (23, 31, channels), dtype=np.uint8)
    for name, filt in FILTERS.items():
        data = _filtered_png(img, ctype, filt)
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        ref = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        got = images.read_png_gray(str(path))
        assert got.dtype == np.uint8 and got.shape == ref.shape
        assert np.abs(got.astype(int) - ref).max() <= tol, name


def test_png_decoder_files_of_both_writers(tmp_path):
    """Exact on gray PNGs that cv2 writes (its own row filters) and that
    the port writes; the colour writer round-trips through cv2; a
    truncated file gives None, as cv2 does; an ASL sequence reads the
    same through ``euroc.frames``'s native loader, ``read_png_gray`` and
    cv2."""
    cam = render.RenderCam(width=96, height=64, fx=48.0, fy=48.0, cx=48.0,
                           cy=32.0)
    R, t, _ = render.orbit_trajectory(3, 0.0, 10.0, radius=2.5)[1]
    img = render.RoomScene(seed=2, device="cpu").render(
        R, t, cam).numpy().astype(np.uint8)
    cv2.imwrite(str(tmp_path / "cv2.png"), img)
    images.write_png(str(tmp_path / "port.png"), img)
    for name in ("cv2.png", "port.png"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(images.read_png_gray(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    bgr = np.random.default_rng(6).integers(0, 256, (13, 17, 3),
                                            dtype=np.uint8)
    images.write_png(str(tmp_path / "bgr.png"), bgr)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "bgr.png")), bgr)
    data = (tmp_path / "cv2.png").read_bytes()
    for cut in (5, 40, len(data) // 2, len(data) - 12, len(data) - 1):
        (tmp_path / "cut.png").write_bytes(data[:cut])
        assert cv2.imread(str(tmp_path / "cut.png")) is None, cut
        assert images.read_png_gray(str(tmp_path / "cut.png")) is None, cut

    traj = render.orbit_trajectory(4, 0.0, 8.0, radius=2.5)
    render.write_asl_sequence(str(tmp_path / "seq"), render.RoomScene(
        seed=2, device="cpu"), traj, cam)
    seq = str(tmp_path / "seq")
    native = list(euroc.frames(seq))
    via_cv2 = list(euroc.frames(seq, backend="cv2"))
    assert len(native) == len(via_cv2) == 4
    for (ta, a), (tb, b), (_, path) in zip(native, via_cv2,
                                           euroc.load_image_index(seq)):
        assert ta == tb and np.array_equal(a, b)
        np.testing.assert_array_equal(images.read_png_gray(path), a)
