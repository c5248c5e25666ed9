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

The program has a fixed batch B: a request of N < B frames is padded with
its last frame's joints and the padding sliced off the answer. One lock
serializes the device calls, which run on one long-lived thread (the HTTP
server starts a thread per request, and a new thread rebuilds cuDNN's
per-thread plan cache). A malformed body (or N > B) gets 400 with
{"error"}; a failure of the device gets 500, and the server then stops and
exits non-zero (a failed kernel build or launch raises: there is no
fallback).

The program names the port's operators (``nhvr_torch::``), which must be
registered before ``torch.export.load``: this module imports
``ops.texture_warp_kernel`` and ``ops.flow_warp_kernel`` for that. A
``<model>.params`` sidecar (export_serving's default) is loaded onto the
device once and passed on every call; without one the program holds its
weights (--bake_weights). At start-up one warm-up call builds the CUDA
kernels if they are not built yet and pays the first launch, so the first
request does not; its seconds are printed. --port 0 binds a free port;
the start-up line names the port bound. On SIGINT the server stops, prints
its kernel launches (``[kernels] launches ...``) and exits 0 (1 after a
device failure).
"""

from __future__ import annotations

import argparse
import base64
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
from .utils.image import _cv2, encode_png

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
        self.lock = threading.Lock()
        self.device_thread = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-device")
        self.failed: Optional[str] = None
        # seconds of the last request's parts (device forward, host copy)
        self.timing = {}
        t0 = time.perf_counter()
        self.render(np.zeros(self.in_shape, np.float32))
        self.warmup_s = time.perf_counter() - t0
        print(f"[serve] warm-up call {self.warmup_s:.3f} s (load "
              f"{self.load_s:.3f} s)", flush=True)

    def render(self, joints: np.ndarray) -> np.ndarray:
        """(N, 18, 3) joints, N <= batch -> (N, S, S, 3) frames: uint8 for
        export_serving's default program, float in [-1, 1] for a
        --raw_float one."""
        n = joints.shape[0]
        if n > self.batch:
            raise ValueError(f"request batch {n} > compiled batch "
                             f"{self.batch}")
        padded = np.zeros(self.in_shape, np.float32)
        padded[:n] = joints
        if n < self.batch:
            padded[n:] = joints[-1]
        with self.lock:
            return self.device_thread.submit(self._call, padded, n).result()

    def _call(self, padded: np.ndarray, n: int) -> np.ndarray:
        x = torch.from_numpy(padded).to(self.device)
        with torch.no_grad():
            t0 = time.perf_counter()
            out = (self.module(self.params, x) if self.params is not None
                   else self.module(x))
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            t1 = time.perf_counter()
            host = out[:n].cpu().numpy()
        self.timing = {"forward_s": t1 - t0,
                       "transfer_s": time.perf_counter() - t1}
        return host


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
            body = json.dumps(obj).encode()
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
            except Exception as e:   # the device failed: stop serving
                model.failed = f"{type(e).__name__}: {e}"
                print(f"[serve] render failed, stopping: {model.failed}",
                      file=sys.stderr, flush=True)
                self._json(500, {"error": model.failed})
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
                return
            t0 = time.perf_counter()
            pngs = [_png_b64(f) for f in frames]
            t1 = time.perf_counter()
            self._json(200, {"frames": pngs})
            model.timing.update(png_s=t1 - t0,
                                json_s=time.perf_counter() - t1)

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
