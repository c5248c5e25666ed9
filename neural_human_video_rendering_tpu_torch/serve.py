"""HTTP frame-rendering server over an exported serving program: the port
of the JAX package's ``serve.py``.

The program written by ``export_serving`` (the whole keypoints -> frame
forward) is loaded once with ``torch.export.load`` and served over plain
HTTP (the standard library's server):

    python -m neural_human_video_rendering_tpu_torch.export_serving \\
        --out model.pt2 --batch 8 <flags>
    python -m neural_human_video_rendering_tpu_torch.serve --model model.pt2 \\
        [--host 127.0.0.1] [--port 8765] [--gpu_ids 0]

API (the JAX server's):
  GET  /healthz          -> {"status": "ok", "batch": B, "joints": [B,18,3],
                             "frame": [B,S,S,3]}
  POST /render           body {"joints": [[[x, y, conf] * 18] * N]}, N <= B
                         -> {"frames": ["<base64 PNG>", ...]} (N entries)

The program has a fixed batch B, and requests that queue for the device
share its replays: when the device frees, the next replay takes every
request already queued, in arrival order, up to the first whose frames
would not fit in the B slots beside those taken before it (no later
request overtakes it). Their joints are packed into one batch, padded
after the last frame with that frame's joints, and each request gets its
own slice of the frames. Nothing waits to fill a batch: a request that
finds the device idle is replayed at once, alone, and a request of B
frames always rides alone. The replays run on one long-lived device
thread (the HTTP server starts a thread per request, and a new thread
rebuilds cuDNN's per-thread plan cache); a replay that fails raises its
exception in every request it carried. A malformed body (or N > B) gets
400 with {"error"}; a failure of the device gets 500, and the server then
stops and exits non-zero (a failed kernel build or launch raises: there
is no fallback).

The program names the port's operators (``nhvr_torch::``), which must be
registered before ``torch.export.load``: this module imports
``ops.texture_warp_kernel`` and ``ops.flow_warp_kernel`` for that. A
``<model>.params`` sidecar (export_serving's default) is loaded onto the
device once and passed on every call; without one the program holds its
weights (--bake_weights). At start-up one warm-up call builds the CUDA
kernels if they are not built yet and pays the first launch, so the first
request does not; its seconds are printed.

On the card the program runs as a CUDA graph (``train/graphs.py``, the
counterpart of the JAX server's compiled ``Exported.call``): the warm-up
call captures it, on the device thread, at the compiled batch, and every
replay copies its packed joints into the graph's input and replays it,
whatever the frames it carries. The kernels' launch counters count one
program's launches a replay. On the CPU the module runs eagerly. The
route is printed once (``[serve] graphed (CUDA graph, 1 capture)`` or
``[serve] eager (cpu)``). --port 0 binds a free port; the start-up line
names the port bound. On SIGINT the server stops, prints
its kernel launches (``[kernels] launches ...``) and exits 0 (1 after a
device failure).
"""

from __future__ import annotations

import argparse
import base64
import collections
import itertools
import json
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from .config import resolve_device
from .ops import flow_warp_kernel  # noqa: F401  (registers nhvr_torch::)
from .ops import texture_warp_kernel  # noqa: F401
from .train.graphs import Dispatch
from .utils.image import _cv2, encode_png
from .utils.spans import span

SIDECAR = ".params"


class _Model:
    """The loaded program and, where there is one, its weights sidecar,
    on `device` (default: the card)."""

    def __init__(self, path: str, device: Optional[torch.device] = None):
        self.device = device if device is not None else resolve_device("0")
        t0 = time.perf_counter()
        exported = torch.export.load(path)
        self.module = exported.module()
        self.params = None
        sidecar = path + SIDECAR
        if os.path.isfile(sidecar):
            self.params = torch.load(sidecar, map_location=self.device,
                                     weights_only=True)
            print(f"[serve] weights sidecar loaded: {sidecar}", flush=True)
        self.load_s = time.perf_counter() - t0
        sig = exported.graph_signature
        nodes = {n.name: n for n in exported.graph.nodes}
        # joints are the last input, the frames the only output
        self.in_shape = tuple(nodes[sig.user_inputs[-1]].meta["val"].shape)
        self.batch = self.in_shape[0]
        self.out_shape = tuple(nodes[sig.user_outputs[0]].meta["val"].shape)
        # requests not yet taken up by a replay, in arrival order, and
        # whether a replay is being packed or is on the device; both
        # guarded by `queue`
        self.queue = threading.Condition()
        self.pending: "collections.deque[_Request]" = collections.deque()
        self.busy = False
        self.device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-device")
        self.failed: Optional[str] = None
        # seconds of the last replay's parts (device forward, host copy)
        self.timing = {}
        self.requests = itertools.count()
        self.dispatch = Dispatch("serve", self.device)
        self.program = self.dispatch.program
        t0 = time.perf_counter()
        self.render(np.zeros(self.in_shape, np.float32))
        self.warmup_s = time.perf_counter() - t0
        print(f"[serve] warm-up call {self.warmup_s:.3f} s (load "
              f"{self.load_s:.3f} s)", flush=True)

    def render(self, joints: np.ndarray) -> np.ndarray:
        """(N, 18, 3) joints, N <= batch -> (N, S, S, 3) frames: uint8 for
        export_serving's default program, float in [-1, 1] for a
        --raw_float one. The request is queued for the device and rides
        in the next replay that has room for it (the module docstring);
        its frames are its slice of that replay's frames.

        Spans (``utils/spans.py``), each with the request's id ``rid``:
        ``serve.request`` (with ``n`` and the compiled ``batch``) holds
        ``serve.lock_wait``, from asking for the device to the moment the
        request's replay takes it up: for the request whose thread starts
        the replay, when it holds the device; for one that rides along,
        when it is taken into the batch. On the device thread,
        ``serve.device`` (``rid`` the request's id where the replay serves
        one request, the tuple of their ids where it serves several) holds
        ``serve.forward`` (the program's own spans inside) and
        ``serve.transfer``."""
        n = joints.shape[0]
        if n > self.batch:
            raise ValueError(f"request batch {n} > compiled batch "
                             f"{self.batch}")
        rid = next(self.requests)
        with span("serve.request", rid=rid, n=n, batch=self.batch):
            request = _Request(rid, joints)
            with span("serve.lock_wait", rid=rid):
                carried = self._take_up(request)
            if carried:
                self._replay(carried)
            request.done.wait()
            if request.error is not None:
                raise request.error
            return request.frames

    def _take_up(self, request: "_Request") -> list:
        """Queues `request` and waits until a replay takes it up. Returns
        the requests of the replay this thread is to start (`request`
        first) where `request` heads the queue when the device is free,
        or [] where another request's replay has taken it."""
        with self.queue:
            self.pending.append(request)
            while not request.taken:
                if not self.busy and self.pending[0] is request:
                    self.busy = True
                    carried, frames = [], 0
                    while (self.pending and frames + len(
                            self.pending[0].joints) <= self.batch):
                        head = self.pending.popleft()
                        head.taken = True
                        carried.append(head)
                        frames += len(head.joints)
                    self.queue.notify_all()     # the riders stop waiting
                    return carried
                self.queue.wait()
            return []

    def _replay(self, carried: list) -> None:
        """One replay of the requests `carried` (its device call on the
        device thread): hands each request its frames, or the replay's
        exception (raised here too), and frees the device for the next
        request in the queue."""
        n = sum(len(r.joints) for r in carried)
        padded = np.zeros(self.in_shape, np.float32)
        padded[:n] = np.concatenate([r.joints for r in carried])
        if n < self.batch:
            padded[n:] = carried[-1].joints[-1]
        rid = (carried[0].rid if len(carried) == 1
               else tuple(r.rid for r in carried))
        try:
            out = self.device_thread.submit(self._device, rid, padded,
                                            n).result()
        except BaseException as e:   # every request it carried raises it
            for r in carried:
                r.error = e
            raise
        else:
            at = 0
            for r in carried:
                r.frames = _part(out, at, at + len(r.joints))
                at += len(r.joints)
        finally:
            with self.queue:
                self.busy = False
                self.queue.notify_all()
            for r in carried:
                r.done.set()

    def _device(self, rid, padded: np.ndarray, n: int) -> np.ndarray:
        """The device thread's part of the replay of request(s) ``rid``."""
        with span("serve.device", rid=rid):
            return self._call(padded, n)

    @property
    def route(self) -> str:
        """The route printed at the warm-up call."""
        return self.dispatch.route

    def forward(self, joints: torch.Tensor) -> torch.Tensor:
        """The program's eager call on (batch, 18, 3) joints on the device
        (the graph's plain version)."""
        with torch.no_grad():
            return (self.module(self.params, joints)
                    if self.params is not None else self.module(joints))

    def _call(self, padded: np.ndarray, n: int) -> np.ndarray:
        """The one device call of a replay: (batch, 18, 3) packed joints ->
        the first `n` frames on the host. ``timing`` then holds the
        replay's ``forward_s`` and ``transfer_s``."""
        x = torch.from_numpy(padded)
        with torch.no_grad():
            with span("serve.forward") as forward:
                # one capture: the compiled batch, the sidecar held by it
                out = self.dispatch(
                    lambda: self.forward(x.to(self.device)),
                    (self.module, self.params), self.in_shape, {"joints": x},
                    lambda st: lambda: self.forward(st["joints"]))
                if out.is_cuda:
                    torch.cuda.synchronize(out.device)
            with span("serve.transfer") as transfer:
                host = out[:n].cpu().numpy()
        self.timing = {"forward_s": forward.seconds,
                       "transfer_s": transfer.seconds}
        return host


class _Request:
    """One ``render`` call: its joints, whether a replay has taken it up,
    and, once ``done`` is set, its frames or the replay's exception."""

    __slots__ = ("rid", "joints", "taken", "done", "frames", "error")

    def __init__(self, rid: int, joints: np.ndarray):
        self.rid = rid
        self.joints = joints
        self.taken = False
        self.done = threading.Event()
        self.frames: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


def _part(frames: np.ndarray, start: int, stop: int) -> np.ndarray:
    """Frames [start, stop) of a replay's answer. Where ``_call`` returned
    an ndarray subclass with instance attributes (a wrapper of ``_call``
    marks its array so), the part carries the same attributes."""
    part = frames[start:stop]
    if hasattr(frames, "__dict__"):
        part.__dict__.update(frames.__dict__)
    return part


def _png_b64(frame: np.ndarray) -> str:
    """One frame as a base64 PNG: OpenCV's encoder where cv2 imports (the
    JAX server's), else the port's own (utils/image.encode_png)."""
    if frame.dtype == np.uint8:          # quantized on the device already
        img = frame
    else:
        img = ((np.clip(frame, -1, 1) + 1) * 127.5).astype(np.uint8)
    cv2 = _cv2()
    if cv2 is not None:
        ok, buf = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        data = buf.tobytes()
    else:
        data = encode_png(img)
    return base64.b64encode(data).decode("ascii")


def make_handler(model: _Model):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet
            pass

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode())

        def _send(self, code: int, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "batch": model.batch,
                                 "joints": list(model.in_shape),
                                 "frame": list(model.out_shape)})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/render":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                joints = np.asarray(req["joints"], np.float32)
                if joints.ndim != 3 or joints.shape[1:] != (18, 3):
                    raise ValueError(
                        f"joints must be (N,18,3), got {joints.shape}")
                if not 1 <= joints.shape[0] <= model.batch:
                    raise ValueError(f"request batch {joints.shape[0]} "
                                     f"outside [1, {model.batch}]")
            except Exception as e:   # a malformed request
                return self._json(400, {"error": str(e)})
            try:
                frames = model.render(joints)
            except Exception as e:
                # the device failed, or refused a program that caught an
                # out-of-memory error (graphs.CaughtOutOfMemory): answer,
                # stop serving and raise again (socketserver prints it)
                model.failed = f"{type(e).__name__}: {e}"
                print(f"[serve] render failed, stopping: {model.failed}",
                      file=sys.stderr, flush=True)
                self._json(500, {"error": model.failed})
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                raise
            # both encodes timed and recorded before the answer leaves, so
            # a client that reads model.timing on the reply finds them
            t0 = time.perf_counter()
            pngs = [_png_b64(f) for f in frames]
            t1 = time.perf_counter()
            body = json.dumps({"frames": pngs}).encode()
            model.timing.update(png_s=t1 - t0,
                                json_s=time.perf_counter() - t1)
            self._send(200, body)

    return Handler


def serve(model_path: str, host: str = "127.0.0.1", port: int = 8765,
          device: Optional[torch.device] = None) -> ThreadingHTTPServer:
    """The server of `model_path` on (host, port), not yet serving; its
    ``model`` attribute is the _Model."""
    model = _Model(model_path, device)
    httpd = ThreadingHTTPServer((host, port), make_handler(model))
    httpd.model = model
    print(f"[serve] {model_path}: batch {model.batch}, frame "
          f"{model.out_shape} on http://{host}:{httpd.server_address[1]}",
          flush=True)
    return httpd


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True,
                   help="program written by export_serving")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--gpu_ids", default="0",
                   help="the card to serve on; -1 for the CPU")
    a = p.parse_args(argv)
    httpd = serve(a.model, a.host, a.port, resolve_device(a.gpu_ids))
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        from .train.drivers import kernel_launches
        print(f"[kernels] launches since the counters' reset: "
              f"{json.dumps(kernel_launches())}", flush=True)
    return 1 if httpd.model.failed else 0


if __name__ == "__main__":
    sys.exit(main())
