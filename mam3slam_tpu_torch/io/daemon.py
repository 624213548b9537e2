"""Process-boundary frame ingestion and live viewing.

Port of ``mam3slam_tpu.io.daemon``.  The reference ingests frames across
a process boundary through ROS topics: ``ImageGrabber::GrabImage`` puts
each arriving image into a per-agent single slot under a mutex and the
agent thread polls it (Examples/ROS/MAM3SLAM/nodes/ros_mono_multi.cc:
48-122, src/Agent.cc:92-113), and it shows live per-agent tracking
windows (src/AgentViewer.cc:21-45, src/MultiAgentViewer.cc:10-26).  Here,
with no image library and no display server:

* ``FrameIngestServer``: a TCP server, one connection per camera; per
  frame a binary header ``<IdII`` (agent u32, ts f64, h u32, w u32) and
  h * w gray bytes.  Frames land in per-agent ``LatestFrameBuffer``
  mailboxes, so the reference's overwrite / drop contract (the freshest
  frame wins) holds across the process boundary.
* ``watch_directory``: the same contract through the file system:
  ``agent<k>_<ts>.png`` files appearing in a directory are decoded by
  ``images.read_png_gray`` and pushed (and deleted, with ``consume``).
* ``MjpegServer``: the live view over HTTP: a multipart/x-mixed-replace
  stream of the latest annotated tracking frame per agent
  (``/agent<k>``), the map view (``/map``), the interactive 3D page
  (``/map3d``) and its JSON snapshot (``/mapdata``); frames are encoded
  by the port's JPEG encoder, on the device the server is given.

Every socket has a timeout and every thread stops on ``close``.  See
``examples/torch_run_daemon.py`` for the wired-up daemon.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from mam3slam_tpu_torch.io import images
from mam3slam_tpu_torch.io.stream import LatestFrameBuffer

_HDR = struct.Struct("<IdII")  # agent u32, ts f64, h u32, w u32
_POLL_S = 0.2                  # socket timeout: how soon a thread sees stop
_SEND_TIMEOUT_S = 5.0          # a viewer that takes no data this long is dropped
_MAX_PIXELS = 1 << 26          # a larger header is not a camera's: hang up


def send_frame(sock: socket.socket, agent: int, ts: float,
               image: np.ndarray) -> None:
    """Client side: push one gray u8 frame."""
    img = np.ascontiguousarray(np.asarray(image, np.uint8))
    h, w = img.shape
    sock.sendall(_HDR.pack(agent, float(ts), h, w) + img.tobytes())


def _recv_exact(conn: socket.socket, n: int,
                stop: threading.Event) -> Optional[bytearray]:
    """``n`` bytes from ``conn``, or None when the peer closed or
    ``stop`` was set."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except socket.timeout:
            if stop.is_set():
                return None
            continue
        except OSError:
            return None
        if not chunk:
            return None
        buf.extend(chunk)
    return buf


class _Server:
    """A listening socket on ``host:port`` (0: any free port) whose
    accept thread hands each connection to ``self._handle`` in a thread
    of its own, until ``close``."""

    def __init__(self, host: str, port: int):
        self._stop = threading.Event()
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(_POLL_S)
        self.port = self._srv.getsockname()[1]
        self._threads = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(_POLL_S)
            th = threading.Thread(target=self._serve_conn, args=(conn,),
                                  daemon=True)
            th.start()
            self._threads.append(th)

    def _serve_conn(self, conn: socket.socket):
        with conn:
            self._handle(conn)

    def close(self):
        """Stop accepting, end every connection's thread and join them."""
        self._stop.set()
        self._accept_thread.join(timeout=5.0)
        try:
            self._srv.close()
        except OSError:
            pass
        for th in self._threads:
            th.join(timeout=5.0)


class FrameIngestServer(_Server):
    """TCP ingest: frames from any number of client processes land in
    per-agent ``LatestFrameBuffer`` mailboxes (the newest frame wins)."""

    def __init__(self, buffers: Dict[int, LatestFrameBuffer],
                 host: str = "127.0.0.1", port: int = 0):
        self.buffers = buffers
        super().__init__(host, port)

    def _handle(self, conn: socket.socket):
        while not self._stop.is_set():
            hdr = _recv_exact(conn, _HDR.size, self._stop)
            if hdr is None:
                return
            agent, ts, h, w = _HDR.unpack(hdr)
            if h * w > _MAX_PIXELS:
                return
            data = _recv_exact(conn, h * w, self._stop)
            if data is None:
                return
            buf = self.buffers.get(agent)
            if buf is not None:
                buf.push(ts, np.frombuffer(data, np.uint8).reshape(h, w))

    def close(self):
        super().close()
        for b in self.buffers.values():
            b.close()


def watch_directory(path: str, buffers: Dict[int, LatestFrameBuffer],
                    poll_s: float = 0.05, consume: bool = True,
                    stop: Optional[threading.Event] = None
                    ) -> threading.Thread:
    """Poll ``path`` for ``agent<k>_<ts>.png`` files and push them into
    the per-agent mailboxes (a robot writing to shared storage).  With
    ``consume`` a file is deleted once ingested; a file still being
    written (truncated) is retried at the next poll.  A file named
    ``STOP`` closes all buffers and ends the watcher."""
    stop = stop or threading.Event()

    def run():
        seen = set()
        while not stop.is_set():
            try:
                names = sorted(os.listdir(path))
            except OSError:
                names = []
            if "STOP" in names:
                break
            for name in names:
                if name in seen or not name.endswith(".png"):
                    continue
                stem = name[:-4]
                if not stem.startswith("agent") or "_" not in stem:
                    continue
                try:
                    agent = int(stem[5:stem.index("_")])
                    ts = float(stem[stem.index("_") + 1:])
                except ValueError:
                    continue
                full = os.path.join(path, name)
                try:
                    img = images.read_png_gray(full)
                except OSError:
                    continue
                if img is None:
                    continue  # partially written; retry next poll
                buf = buffers.get(agent)
                if buf is not None:
                    buf.push(ts, img)
                if consume:
                    try:
                        os.remove(full)
                    except OSError:
                        pass
                else:
                    seen.add(name)
            time.sleep(poll_s)
        for b in buffers.values():
            b.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


class MjpegServer(_Server):
    """Live view over plain HTTP (no display server needed):
    ``GET /agent<k>`` streams multipart JPEG of the latest annotated
    tracking frame; ``GET /map`` streams the map view (the reference
    MapDrawer window, src/MapDrawer.cc:1-419: publish
    ``viewer.draw_map_image`` under the key ``"map"`` at ~1 Hz);
    ``GET /map3d`` serves a self-contained interactive 3D viewer page
    (rotate / zoom / pan with the mouse) that polls ``GET /mapdata`` (the
    JSON snapshot published with ``publish_json``, see
    ``viewer.map_snapshot``); ``GET /`` lists all streams.  ``publish``
    encodes a frame as a quality-80 JPEG on ``device`` (the card unless
    the caller passes ``device="cpu"``), whatever device the frame lies
    on."""

    BOUNDARY = b"--mam3frame"

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 fps: float = 20.0, device=torch.device("cuda")):
        self._frames: Dict[object, bytes] = {}
        self._json: Dict[str, bytes] = {}
        self._cv = threading.Condition()
        self._period = 1.0 / fps
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MjpegServer: no CUDA device; pass "
                               "device='cpu' to encode on the CPU")
        super().__init__(host, port)

    def publish(self, agent, bgr_image: np.ndarray) -> bytes:
        """Encode and serve ``bgr_image`` under ``agent`` (an agent id, or
        the string key ``"map"``); returns the JPEG."""
        jpg = images.encode_jpeg(bgr_image, device=self.device)
        with self._cv:
            self._frames[agent] = jpg
            self._cv.notify_all()
        return jpg

    def publish_json(self, key: str, obj) -> None:
        """Publish a JSON document (e.g. ``viewer.map_snapshot``) under
        ``/<key>data``: the interactive ``/map3d`` page polls ``/mapdata``
        at ~1 Hz."""
        blob = json.dumps(obj, separators=(",", ":")).encode()
        with self._cv:
            self._json[key] = blob

    def _handle(self, conn: socket.socket):
        req = b""
        while not req and not self._stop.is_set():
            try:
                req = conn.recv(4096)
            except socket.timeout:
                continue
            except OSError:
                return
        req = req.decode("latin1", "replace")
        conn.settimeout(_SEND_TIMEOUT_S)
        path = req.split(" ")[1] if " " in req else "/"
        if path.startswith("/agent"):
            try:
                agent = int(path[6:])
            except ValueError:
                agent = 0
            self._stream(conn, agent)
        elif path.startswith("/map3d"):
            self._send(conn, _MAP3D_HTML, b"text/html")
        elif path.startswith("/mapdata"):
            with self._cv:
                blob = self._json.get("map", b"{}")
            self._send(conn, blob, b"application/json")
        elif path.startswith("/map"):
            self._stream(conn, "map")
        else:
            with self._cv:
                agents = sorted(self._frames, key=str)
                has_3d = "map" in self._json
            body = ("<html><body>" + "".join(
                f'<h3>{a}</h3><img src="/map"/>' if a == "map" else
                f'<h3>agent {a}</h3><img src="/agent{a}"/>'
                for a in agents)
                + ('<p><a href="/map3d">interactive 3D map</a></p>'
                   if has_3d else "")
                + "</body></html>").encode()
            self._send(conn, body, b"text/html")

    @staticmethod
    def _send(conn: socket.socket, body: bytes, ctype: bytes):
        try:
            conn.sendall(b"HTTP/1.0 200 OK\r\nContent-Type: " + ctype
                         + b"\r\nContent-Length: " + str(len(body)).encode()
                         + b"\r\n\r\n" + body)
        except OSError:
            pass

    def _stream(self, conn: socket.socket, agent):
        try:
            conn.sendall(
                b"HTTP/1.0 200 OK\r\nContent-Type: multipart/x-mixed-replace;"
                b"boundary=" + self.BOUNDARY[2:] + b"\r\n\r\n")
        except OSError:
            return
        last = None
        while not self._stop.is_set():
            with self._cv:
                self._cv.wait(timeout=self._period)
                jpg = self._frames.get(agent)
            if jpg is None or jpg is last:
                continue
            last = jpg
            try:
                conn.sendall(
                    self.BOUNDARY + b"\r\nContent-Type: image/jpeg\r\n"
                    b"Content-Length: " + str(len(jpg)).encode()
                    + b"\r\n\r\n" + jpg + b"\r\n")
            except OSError:
                return


# Self-contained interactive 3D viewer (no external assets — the host is
# typically airgapped): canvas renderer with mouse orbit/zoom/pan over the
# ``/mapdata`` JSON snapshot (``viewer.map_snapshot``).  Functional twin
# of the reference's interactive Pangolin map window
# (src/MapDrawer.cc:1-419, src/Viewer.cc, src/MultiAgentViewer.cc:10-26).
_MAP3D_HTML = b"""<!doctype html><html><head><meta charset=utf-8>
<title>MAM3SLAM map</title><style>
html,body{margin:0;height:100%;background:#101014;overflow:hidden}
#c{width:100%;height:100%;display:block;cursor:grab}
#hud{position:fixed;top:8px;left:10px;color:#9aa;font:12px monospace;
pointer-events:none;white-space:pre}
</style></head><body><canvas id=c></canvas><div id=hud>loading...</div>
<script>
'use strict';
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
const hud=document.getElementById('hud');
let data=null,yaw=-0.7,pitch=0.35,dist=0,panx=0,pany=0,ctr=[0,0,0];
const AG=['#ff9f40','#4dc9f6','#f67019','#f53794','#acc236','#00a950'];
const SEGCOL=i=>i===0?'rgba(80,200,120,0.35)':i===1?'#5b8dd9'
  :AG[(i-2)%AG.length];
const PCOL=['#c8c8d8','#e8b4b8','#b4e8c8','#e8e0a0','#c0b4e8','#a0d8e8'];
async function poll(){
 try{const r=await fetch('/mapdata');
  if(r.ok){const d=await r.json();
   if(d.points){data=d;
    if(dist===0){dist=3.2*(d.span||1);
     let n=d.points.length;
     if(n){let s=[0,0,0];
      for(const p of d.points){s[0]+=p[0];s[1]+=p[1];s[2]+=p[2];}
      ctr=[s[0]/n,s[1]/n,s[2]/n];}}}}
 }catch(e){}
 setTimeout(poll,1000);}
function proj(x,y,z,f,w,h){
 const cy=Math.cos(yaw),sy=Math.sin(yaw),
       cp=Math.cos(pitch),sp=Math.sin(pitch);
 x-=ctr[0];y-=ctr[1];z-=ctr[2];
 const x1=cy*x+sy*z,z1=-sy*x+cy*z,y1=cp*y-sp*z1,z2=sp*y+cp*z1+dist;
 if(z2<1e-3)return null;
 return [w/2+panx+f*x1/z2,h/2+pany+f*y1/z2,z2];}
function draw(){
 const w=cv.width=innerWidth,h=cv.height=innerHeight,
       f=0.9*Math.min(w,h);
 ctx.fillStyle='#101014';ctx.fillRect(0,0,w,h);
 if(!data){requestAnimationFrame(draw);return;}
 ctx.lineWidth=1;
 for(let i=0;i<data.segs.length;i++){
  const s=data.segs[i],a=proj(s[0],s[1],s[2],f,w,h),
        b=proj(s[3],s[4],s[5],f,w,h);
  if(!a||!b)continue;
  ctx.strokeStyle=SEGCOL(data.scls[i]);
  ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);
  ctx.stroke();}
 for(let i=0;i<data.points.length;i++){
  const p=data.points[i],q=proj(p[0],p[1],p[2],f,w,h);
  if(!q)continue;
  const r=Math.max(0.6,Math.min(2.5,1.8*dist/(3*q[2])));
  ctx.fillStyle=PCOL[((data.pmap[i]%6)+6)%6];
  ctx.fillRect(q[0]-r/2,q[1]-r/2,r,r);}
 const st=data.stats||{};
 hud.textContent='KFs '+(st.kfs||0)+'  MPs '+(st.mps||0)
   +'  agents '+(st.agents||0)
   +'\\ndrag rotate | wheel zoom | shift-drag pan';
 requestAnimationFrame(draw);}
let drag=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey||e.button===2];
 cv.style.cursor='grabbing';};
onmouseup=()=>{drag=null;cv.style.cursor='grab';};
onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){panx+=dx;pany+=dy;}
 else{yaw+=dx*0.008;
  pitch=Math.max(-1.55,Math.min(1.55,pitch+dy*0.008));}
 drag=[e.clientX,e.clientY,drag[2]];};
cv.onwheel=e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.0012);};
cv.oncontextmenu=e=>e.preventDefault();
poll();draw();
</script></body></html>"""
