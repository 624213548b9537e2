"""Port twins of tests/test_stream.py's buffer tests: the frame-drop policy
of mam3slam_tpu_torch.io.stream (a slow tracker drops intermediate frames
and always takes the freshest; every frame is accounted for), with the
reference's bounds.  Each test also runs the reference's buffer on the
same interlocked pushes and compares the counters exactly."""

import time

from mam3slam_tpu.io import stream as jstream
from mam3slam_tpu_torch.io.stream import LatestFrameBuffer, replay_realtime


def test_slow_consumer_drops_and_gets_freshest():
    buf = LatestFrameBuffer()
    replay_realtime([(i / 100.0, i) for i in range(100)], buf,
                    rate_hz=100.0)  # 10 ms period
    taken = []
    while True:
        item = buf.take(timeout_s=2.0)
        if item is None:
            break
        taken.append(item)
        time.sleep(0.035)  # tracker ~3.5x slower than the camera
    assert buf.n_pushed == 100
    assert buf.n_taken == len(taken)
    assert buf.n_taken + buf.n_dropped == buf.n_pushed
    assert buf.n_dropped > 30, buf.n_dropped
    ts = [t for t, _ in taken]
    assert all(b > a for a, b in zip(ts, ts[1:]))
    assert taken[-1][1] > 90


def test_fast_consumer_sees_everything():
    """Interlocked pushes and takes: nothing is dropped; the reference's
    buffer gives the same frames and counters."""
    out = []
    for cls in (LatestFrameBuffer, jstream.LatestFrameBuffer):
        buf = cls()
        taken = []
        for i in range(50):
            buf.push(i / 1000.0, i)
            if i % 3 == 2:           # two pushes in a row: one drop
                buf.push(i / 1000.0 + 1e-4, -i)
            taken.append(buf.take(timeout_s=2.0))
        buf.close()
        assert buf.take(timeout_s=0.1) is None
        out.append((taken, buf.n_pushed, buf.n_taken, buf.n_dropped))
    assert out[0] == out[1]
    taken, pushed, n_taken, dropped = out[0]
    assert (pushed, n_taken, dropped) == (66, 50, 16)
    assert [i for _, i in taken] == [-i if i % 3 == 2 else i
                                     for i in range(50)]


def test_fast_consumer_realtime_nearly_lossless():
    """Wall-clock paced: a consumer much faster than the camera sees
    (almost) everything (the reference test's drop budget of 2)."""
    buf = LatestFrameBuffer()
    replay_realtime([(i / 1000.0, i) for i in range(50)], buf, rate_hz=50.0)
    taken = []
    while True:
        item = buf.take(timeout_s=2.0)
        if item is None:
            break
        taken.append(item)
    assert buf.n_dropped <= 2, buf.n_dropped
    assert len(taken) >= 48
    ids = [i for _, i in taken]
    assert all(b > a for a, b in zip(ids, ids[1:]))
    assert ids[-1] == 49
