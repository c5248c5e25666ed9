"""PyTorch port, the HTTP server over an exported program (``serve.py``),
the round trip of the JAX package's tests/test_serve.py: export a tiny
program with its weights sidecar, serve it on a free port, check
/healthz, a one-frame request (padded to the program's batch and sliced
back) against a direct call of the float program within 1.5 / 127.5, and
the 400 of a malformed body. Then the server as its own process (the
operators registered by its own imports): the same request answers the
same PNG bytes. A failing device call answers 500, stops the server and
makes main exit non-zero.
"""

import base64
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu_torch import export_serving as es
from neural_human_video_rendering_tpu_torch import serve as srv
from neural_human_video_rendering_tpu_torch.config import TestOptions
from neural_human_video_rendering_tpu_torch.utils.image import decode_png

TINY = ("--loadSize 32 --tex_tile 16 --ngf 4 --ngf_global 4 "
        "--n_blocks_translate 1 --n_downsample_translate 2 "
        "--n_blocks_global 1 --n_downsample_global 1 --n_blocks_bg 1 "
        "--n_downsample_bg 1 --dtype float32 --pose_heatmaps --coord_conv "
        "--gpu_ids -1").split()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    opt = TestOptions().parse(TINY + ["--checkpoints_dir", str(root)],
                              save=False)
    path = str(root / "m.pt2")
    es.save_artifact(opt, 2, path)                  # uint8, with sidecar
    direct, joints, _ = es.build_exported(opt, 2, bake_weights=True,
                                          out_uint8=False)
    with torch.no_grad():
        ref = direct.module()(joints).numpy()
    return path, joints.numpy(), ref


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/render", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _frame(b64):
    return decode_png(base64.b64decode(b64))


def test_serve_roundtrip(artifact, capsys):
    path, joints, ref = artifact
    httpd = srv.serve(path, port=0, device=torch.device("cpu"))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        port = httpd.server_address[1]
        out = capsys.readouterr().out
        assert "warm-up call" in out and f":{port}" in out
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h == {"status": "ok", "batch": 2, "joints": [2, 18, 3],
                     "frame": [2, 32, 32, 3]}
        # one frame: padded to the batch of 2, sliced back
        got = _post(port, {"joints": joints[1:].tolist()})
        assert len(got["frames"]) == 1
        served = _frame(got["frames"][0]).astype(np.float32) / 127.5 - 1.0
        assert served.shape == ref[1].shape
        np.testing.assert_allclose(served, np.clip(ref[1], -1, 1),
                                   atol=1.5 / 127.5)
        both = _post(port, {"joints": joints.tolist()})
        assert both["frames"][1] == got["frames"][0]
        assert set(httpd.model.timing) == {"forward_s", "transfer_s",
                                           "png_s", "json_s"}
        for bad in ({"joints": [[1, 2]]}, {"joints": np.zeros(
                (3, 18, 3)).tolist()}, {"nope": 1}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(port, bad)
            assert e.value.code == 400
            assert "error" in json.loads(e.value.read())
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_serve_in_its_own_process(artifact):
    """python -m ...serve --port 0 in a fresh process: the start-up line
    names the port; the answer equals the in-process server's bytes."""
    path, joints, _ = artifact
    body = {"joints": joints[:1].tolist()}
    httpd = srv.serve(path, port=0, device=torch.device("cpu"))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        want = _post(httpd.server_address[1], body)
    finally:
        httpd.shutdown()
        httpd.server_close()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "neural_human_video_rendering_tpu_torch.serve",
         "--model", path, "--port", "0", "--gpu_ids", "-1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO)
    try:
        port, lines = None, []
        for line in proc.stdout:
            lines.append(line)
            if "on http://" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert port, "".join(lines)
        assert _post(port, body) == want
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def test_device_failure_answers_500_and_stops(artifact, monkeypatch):
    path, joints, _ = artifact
    httpd = srv.serve(path, port=0, device=torch.device("cpu"))

    def broken(*args):
        raise RuntimeError("texture_warp_topk_fwd launch failed: CUDA error 1")

    httpd.model.module = broken
    monkeypatch.setattr(srv, "serve", lambda *a, **k: httpd)
    rc = []
    t = threading.Thread(target=lambda: rc.append(srv.main(
        ["--model", path, "--port", "0", "--gpu_ids", "-1"])), daemon=True)
    t.start()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(httpd.server_address[1], {"joints": joints[:1].tolist()})
    assert e.value.code == 500
    assert "launch failed" in json.loads(e.value.read())["error"]
    t.join(timeout=60)
    assert rc == [1]
