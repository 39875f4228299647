"""Interactive viewer: a render thread and a threaded HTTP server
(counterpart of tpuray/viewer/server.py).

The Renderer draws frames on its device (the CUDA card unless the caller
asks for the CPU) on one render thread, whose kernels launch on that
thread's current stream. A frame goes to the host once, as the tonemapped
image of the selected debug view, and is published as a PNG. Browsers
long-poll /frame.png?seq=N for the first frame newer than N (X-Seq and
X-Stats headers), read /state (parameters, view, size, camera) and POST
JSON control events to /control: rotate, dolly, pan, param, view, reset.
Any camera or parameter change resets temporal accumulation, and a
parameter reaches the next frame (Renderer.cfg's setter). A POSTed event
is converted as _apply_events reads it (parse_event) and answered 400
when it cannot be applied, so no client can stop the render thread.

A fault on the render thread is kept, not swallowed: it stops the loop,
ends every long poll with a 500, and check() and serve_forever() raise it.

Usage: python -m tpuray_torch.cli.main view --size 400 [--device cpu]
"""
from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from tpuray_torch.io.image import encode_png
from tpuray_torch.render.renderer import Renderer, select_debug_view, tonemap
from tpuray_torch.scene.camera import OrbitCamera
from tpuray_torch.scene.config import DebugView, RenderConfig
from tpuray_torch.viewer.ui import SLIDERS, render_page

# the parameters the page may set, with their types
UI_PARAMS = {
    "max_tracing_depth": int, "num_atrous_iterations": int,
    "sigma_n": float, "sigma_l": float,
    "reproj_depth_threshold": float, "reproj_normal_threshold": float,
    "clamp_threshold": float, "accumulate": bool, "use_normal_map": bool,
}
# a slider's parameter takes the values of the page's slider
_RANGES = {sid: (lo, hi) for _, sid, lo, hi, _ in SLIDERS}


def _finite(x) -> float:
    v = float(x)
    if not math.isfinite(v):
        raise ValueError(f"{x!r} is not a finite number")
    return v


def parse_event(ev) -> dict:
    """A POSTed control event with its values converted as _apply_events
    reads them. Raises ValueError, TypeError or KeyError for one that it
    could not apply: a missing key, a value that does not convert, a
    camera step that is not finite, a parameter outside its slider's range
    or a view that is not a number. Unknown types and parameter names stay
    as they are (_apply_events ignores them, as tpuray does)."""
    if not isinstance(ev, dict):
        raise TypeError(f"a control event is a JSON object, not {type(ev).__name__}")
    t = ev.get("type")
    if t == "rotate":
        return dict(ev, dx=_finite(ev["dx"]), dy=_finite(ev["dy"]))
    if t == "dolly":
        return dict(ev, d=_finite(ev["d"]))
    if t == "pan":
        return dict(ev, forward=_finite(ev.get("forward", 0.0)),
                    right=_finite(ev.get("right", 0.0)))
    if t == "param" and ev.get("name") in UI_PARAMS:
        name = ev["name"]
        val = UI_PARAMS[name](ev["value"])
        lo, hi = _RANGES.get(name, (-math.inf, math.inf))
        if not lo <= val <= hi:
            raise ValueError(f"{name}={val!r} lies outside [{lo}, {hi}]")
        return dict(ev, value=val)
    if t == "view":
        return dict(ev, view=int(ev["view"]))
    return ev


class ViewerServer:
    """Owns the Renderer and an OrbitCamera; applies control events between
    frames and publishes (seq, png bytes, stats) to the HTTP handlers.
    device: the Renderer's ("cuda" raises without a CUDA card)."""

    def __init__(self, scene, cfg: RenderConfig, host: str = "127.0.0.1",
                 port: int = 8008, max_fps: float = 60.0, device="cuda"):
        self.renderer = Renderer(scene, cfg, device=device)
        self.camera = OrbitCamera(width=cfg.width, height=cfg.height)
        self.view = DebugView.FINAL
        self.host, self.port = host, port
        self.max_fps = max_fps
        self.error: BaseException | None = None  # what ended the render thread
        self._events: list[dict] = []
        self._lock = threading.Lock()          # guards _events
        self._pub = threading.Condition()      # guards seq, png, stats
        self.seq = 0
        self.png: bytes = b""
        self.stats: dict = {}
        self._stop = threading.Event()
        self._httpd: ThreadingHTTPServer | None = None
        self._threads: list[threading.Thread] = []

    # ---- control ----
    def submit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def _apply_events(self) -> None:
        with self._lock:
            evs, self._events = self._events, []
        dirty = False
        for ev in evs:
            t = ev.get("type")
            if t == "rotate":
                self.camera.rotate(float(ev["dx"]), float(ev["dy"]))
                dirty = True
            elif t == "dolly":
                self.camera.dolly(float(ev["d"]))
                dirty = True
            elif t == "pan":
                self.camera.pan_by(float(ev.get("forward", 0.0)),
                                   float(ev.get("right", 0.0)))
                dirty = True
            elif t == "param":
                name = ev.get("name")
                if name in UI_PARAMS:
                    val = UI_PARAMS[name](ev["value"])
                    self.renderer.cfg = self.renderer.cfg.replace(**{name: val})
                    dirty = True
            elif t == "view":
                try:
                    self.view = DebugView(int(ev["view"]))
                except ValueError:
                    pass
            elif t == "reset":
                dirty = True
        if dirty:
            self.renderer.reset()  # any change restarts temporal accumulation

    # ---- render loop ----
    def render_once(self) -> tuple[bytes, dict]:
        """Apply the pending events, render a frame and encode the selected
        view -> (png bytes, stats)."""
        t0 = time.perf_counter()
        self._apply_events()
        r = self.renderer
        out = r.step(self.camera.snapshot())
        img = tonemap(select_debug_view(out, self.view), r.cfg.tonemap_limit,
                      r.cfg.gamma).cpu().numpy()
        png = encode_png(img, compress_level=1)
        dt = time.perf_counter() - t0
        frame = r.state.frame_idx
        return png, {
            "text": (f"frame {frame}  |  {dt * 1e3:.1f} ms/frame ({1.0 / max(dt, 1e-9):.1f} fps)"
                     f"\nview: {self.view.name.lower()}"
                     f"  depth={r.cfg.max_tracing_depth}"
                     f" atrous={r.cfg.num_atrous_iterations}"),
            "ms": dt * 1e3,
            "frame": frame,
        }

    def _render_loop(self) -> None:
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                png, stats = self.render_once()
                with self._pub:
                    self.seq += 1
                    self.png = png
                    self.stats = stats
                    self._pub.notify_all()
                budget = 1.0 / self.max_fps - (time.perf_counter() - t0)
                if budget > 0:
                    self._stop.wait(budget)
        except Exception as e:  # kept for check(); the thread ends here
            self.error = e
            self._stop.set()
            with self._pub:
                self._pub.notify_all()

    def check(self) -> None:
        """Raise what ended the render thread, if anything did."""
        if self.error is not None:
            raise RuntimeError("the viewer's render thread failed") from self.error

    def wait_frame(self, after_seq: int, timeout: float = 25.0):
        """Block until a frame newer than after_seq exists (long poll) ->
        (seq, png, stats), or None after `timeout` seconds or once the
        server stops. Raises if the render thread failed."""
        after_seq = max(after_seq, 0)  # seq 0: no frame published yet
        deadline = time.monotonic() + timeout
        with self._pub:
            while self.seq <= after_seq and not self._stop.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._pub.wait(remaining)
            self.check()
            if self.seq <= after_seq:
                return None
            return self.seq, self.png, self.stats

    def state_json(self) -> bytes:
        cfg = self.renderer.cfg
        params = {k: getattr(cfg, k) for k in UI_PARAMS}
        return json.dumps({
            "params": params, "view": int(self.view),
            "width": cfg.width, "height": cfg.height,
            "camera": {"yaw": self.camera.yaw_deg,
                       "pitch": self.camera.pitch_deg,
                       "radius": self.camera.radius},
        }).encode()

    # ---- lifecycle ----
    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str,
                      headers: dict | None = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(200, render_page().encode(), "text/html")
                elif url.path == "/frame.png":
                    q = parse_qs(url.query)
                    after = int(q.get("seq", ["-1"])[0])
                    try:
                        got = server.wait_frame(after)
                    except RuntimeError as e:
                        self._send(500, repr(e.__cause__).encode(), "text/plain")
                        return
                    if got is None:
                        self._send(204, b"", "text/plain")
                        return
                    seq, png, stats = got
                    self._send(200, png, "image/png", {
                        "X-Seq": str(seq), "X-Stats": json.dumps(stats)})
                elif url.path == "/state":
                    self._send(200, server.state_json(), "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if urlparse(self.path).path != "/control":
                    self._send(404, b"not found", "text/plain")
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    ev = parse_event(json.loads(self.rfile.read(n) or b"{}"))
                except (ValueError, TypeError, KeyError) as e:  # JSONDecodeError too
                    self._send(400, json.dumps({"ok": False, "error": str(e)}).encode(),
                               "application/json")
                    return
                server.submit(ev)
                self._send(200, b'{"ok":true}', "application/json")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port=0
        for target in (self._render_loop, self._httpd.serve_forever):
            th = threading.Thread(target=target, daemon=True)
            th.start()
            self._threads.append(th)

    def stop(self) -> None:
        self._stop.set()
        with self._pub:
            self._pub.notify_all()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for th in self._threads:
            th.join(timeout=30.0)

    def serve_forever(self) -> None:
        """Print the URL, then serve until Ctrl-C (or until the render
        thread fails, which is raised)."""
        print(f"tpuray_torch viewer: http://{self.host}:{self.port}/", flush=True)
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
        self.check()
