"""HTTP serving throughput ladder: the port of the JAX package's
tools/round4/bench_serve.py (the same flags and JSON keys, plus
--gpu_ids).

Starts the port's server (``python -m neural_human_video_rendering_tpu_torch.serve``)
on an export_serving program as a subprocess, waits for /healthz, then
measures end-to-end frames/s at each concurrency level: a thread pool of
identical POST /render calls of the program's batch. The server runs one
device call at a time; the PNG encode of an answer runs on its request's
thread, so concurrency above 1 may overlap it with the next forward.

    python -m neural_human_video_rendering_tpu_torch.bench_serve \\
        --model model.pt2 --keypoints KEYPOINT_DIR [--gpu_ids -1]

Writes one JSON {"artifact", "batch", "ladder": {"1": fps, "4": fps},
"n_requests"} (--out) and prints it. --port 0 (the default) lets the
server bind a free port, read from its start-up line. At the end the
server gets SIGINT by PID (a kill if it has not exited in 30 s); its exit
code and kernel launches are printed.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

PKG = "neural_human_video_rendering_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND = re.compile(r"\[serve\] .* on http://([^:/\s]+):(\d+)")
LAUNCHES = re.compile(r"\[kernels\] launches since the counters' reset: "
                      r"(\{[^}]*\})")


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def start_server(model: str, port: int, gpu_ids: str, timeout: float = 600.0):
    """The server subprocess and its base URL, once its start-up line has
    named the bound port; its output is drained by a thread into
    ``srv.lines``."""
    srv = subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.serve", "--model", model, "--port",
         str(port), f"--gpu_ids={gpu_ids}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    srv.lines = []
    bound = threading.Event()
    found = {}

    def drain():
        for line in srv.stdout:
            srv.lines.append(line)
            m = BOUND.search(line)
            if m and not bound.is_set():
                found["url"] = f"http://{m.group(1)}:{m.group(2)}"
                bound.set()
        bound.set()

    srv.drain = threading.Thread(target=drain, daemon=True)
    srv.drain.start()
    if not bound.wait(timeout) or "url" not in found:
        srv.kill()
        srv.wait()
        raise SystemExit("server died or never bound a port:\n"
                         + "".join(srv.lines[-40:]))
    return srv, found["url"]


def wait_healthy(srv, base: str, tries: int = 1200) -> dict:
    for _ in range(tries):
        if srv.poll() is not None:
            raise SystemExit("server died during start-up:\n"
                             + "".join(srv.lines[-40:]))
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                return json.loads(r.read())
        except OSError:
            time.sleep(0.5)
    raise SystemExit("server never became healthy")


def stop_server(srv, timeout: float = 30.0) -> dict:
    """SIGINT to the server's PID (it stops and prints its launches), a
    kill if it has not exited in ``timeout`` s -> {"rc", "launches"}."""
    srv.send_signal(signal.SIGINT)
    try:
        srv.wait(timeout)
    except subprocess.TimeoutExpired:
        srv.kill()
        srv.wait()
    srv.drain.join(10)               # its output to the end
    launches = None
    for line in srv.lines:
        m = LAUNCHES.search(line)
        if m:
            launches = json.loads(m.group(1))
    return {"rc": srv.returncode, "launches": launches}


def driving_payload(keypoints: str, batch: int, S: int) -> dict:
    """A /render body of the first ``batch`` poses of a keypoint dir,
    fitted onto the program's S x S canvas (0.9 S over the joints' span)."""
    from .data.keypoints import load_pose_dir
    _names, joints = load_pose_dir(keypoints)
    joints = joints[:batch].copy()
    span = max(joints[..., 0].max(), joints[..., 1].max(), 1.0)
    joints[..., :2] *= 0.9 * S / span
    return {"joints": [j.tolist() for j in joints]}


def ladder(base: str, payload: dict, batch: int, requests: int = 12,
           concurrency: str = "1,4") -> dict:
    """Frames/s at each concurrency level: ``requests`` identical POST
    /render calls from a pool of that many threads, after one warm-up
    request."""
    _post(base + "/render", payload)   # warm the call path
    out = {}
    for conc in [int(c) for c in concurrency.split(",")]:
        t0 = time.time()
        with cf.ThreadPoolExecutor(max_workers=conc) as ex:
            futs = [ex.submit(_post, base + "/render", payload)
                    for _ in range(requests)]
            for f in futs:
                resp = f.result()
                assert "frames" in resp, resp
        dt = time.time() - t0
        out[str(conc)] = round(batch * requests / dt, 2)
        print(f"[bench_serve] concurrency {conc}: {out[str(conc)]} FPS",
              flush=True)
    return out


def run_ladder(model: str, keypoints: str, requests: int = 12,
               concurrency: str = "1,4", port: int = 0, gpu_ids: str = "0"):
    """The ladder -> (the result JSON, the server's {"rc", "launches"})."""
    srv, base = start_server(model, port, gpu_ids)
    try:
        health = wait_healthy(srv, base)
        batch = health["batch"]
        print(f"[bench_serve] healthy: batch {batch} frame {health['frame']}",
              flush=True)
        payload = driving_payload(keypoints, batch, health["frame"][1])
        result = {"artifact": os.path.basename(model), "batch": batch,
                  "ladder": ladder(base, payload, batch, requests,
                                   concurrency),
                  "n_requests": requests}
    finally:
        server = stop_server(srv)
    print(f"[bench_serve] server exited rc {server['rc']}, launches "
          f"{json.dumps(server['launches'])}", flush=True)
    return result, server


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--requests", type=int, default=12,
                    help="timed requests per concurrency level")
    ap.add_argument("--concurrency", default="1,4")
    ap.add_argument("--keypoints", required=True,
                    help="dir of OpenPose JSONs to drive with")
    ap.add_argument("--out", default="")
    ap.add_argument("--gpu_ids", default="0",
                    help="the server's card; -1 for the CPU")
    ns = ap.parse_args(argv)
    result, _ = run_ladder(ns.model, ns.keypoints, ns.requests,
                           ns.concurrency, ns.port, ns.gpu_ids)
    print(json.dumps(result), flush=True)
    if ns.out:
        with open(ns.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
