"""Live-stream frame pump with the reference's frame-drop policy.

Port of ``mam3slam_tpu.io.stream`` (pure host code).  The reference's ROS
driver stuffs each arriving image into a SINGLE per-agent slot under a
mutex and ``Agent::Run`` polls it: when tracking is slower than the
camera, newer frames OVERWRITE the slot and the intermediate frames are
dropped, so tracking always works on the freshest image and the motion
model bridges the gap.  The buffer counts pushes, takes and drops.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional, Tuple


class LatestFrameBuffer:
    """Single-slot frame mailbox: writers overwrite, readers take newest.
    ``n_pushed`` / ``n_taken`` / ``n_dropped`` expose the drop policy."""

    def __init__(self):
        self._lock = threading.Lock()
        self._frame = None          # (ts, image)
        self._fresh = False
        self.n_pushed = 0
        self.n_taken = 0
        self.n_dropped = 0
        self.closed = False

    def push(self, ts: float, image) -> None:
        """Writer side (camera callback): overwrite the slot."""
        with self._lock:
            if self._fresh:
                self.n_dropped += 1   # the unconsumed frame is lost
            self._frame = (ts, image)
            self._fresh = True
            self.n_pushed += 1

    def close(self) -> None:
        with self._lock:
            self.closed = True

    def take(self, poll_s: float = 0.001,
             timeout_s: Optional[float] = None):
        """Reader side (tracking loop): newest frame, or None when the
        stream closed with nothing pending (or ``timeout_s`` passed)."""
        t0 = time.perf_counter()
        while True:
            with self._lock:
                if self._fresh:
                    self._fresh = False
                    self.n_taken += 1
                    return self._frame
                if self.closed:
                    return None
            if (timeout_s is not None
                    and time.perf_counter() - t0 > timeout_s):
                return None
            time.sleep(poll_s)


def replay_realtime(frames: Iterable[Tuple[float, object]],
                    buf: LatestFrameBuffer, rate_hz: float,
                    speed: float = 1.0) -> threading.Thread:
    """Feeder thread pushing ``frames`` into ``buf`` at the camera rate
    (wall-clock paced, like a live topic).  Returns the started thread;
    the buffer is closed when the sequence ends."""
    period = 1.0 / (rate_hz * speed)

    def run():
        nxt = time.perf_counter()
        for ts, img in frames:
            now = time.perf_counter()
            if now < nxt:
                time.sleep(nxt - now)
            buf.push(ts, img)
            nxt += period
        buf.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th
