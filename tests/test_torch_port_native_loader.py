"""PyTorch port, the native decode/prefetch runtime (data/native_loader.py
+ native/loader.cpp, the port's copy) against the JAX package's, both
built with g++ on this host: decode_image in all three modes on PNG
(gray, gray + alpha, RGB, RGBA, palette with and without tRNS, 16-bit)
and JPEG at integer and non-integer ratios, from square and non-square
sources; decode_image_plain (numpy) on the decoded pixels; NativeBatcher
with 1 and 3 threads; the error counts and a refused submit; the IOError
-> OpenCV fallback for a file loader.cpp does not decode; a first build
from several processes at once; the copy's source against the JAX
package's. Everything is exact (bit-equal arrays).

The JAX package builds its library in place under native/build/ with no
guard across processes and keeps a failed build for the life of the
process, so a test process that loses a concurrent first build (several
pytest-xdist workers collecting tests/test_native_loader.py at once)
would see it missing for good. jax_native_loader_ready() retries that
build once, alone under a file lock, before any case here decides that
the library does not build on this host.
"""

import fcntl
import os
import struct
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from neural_human_video_rendering_tpu.data import dataset as jds
from neural_human_video_rendering_tpu.data import native_loader as jnl
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.data import native_loader as tnl
from neural_human_video_rendering_tpu_torch.utils import image as timg

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "neural_human_video_rendering_tpu_torch"
MODES = (tnl.MODE_RGB, tnl.MODE_GRAY, tnl.MODE_LABEL)


def _jax_build_error():
    """The compiler's complaint about the JAX package's loader.cpp: its own
    g++ command line, into a temporary file."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", jnl._SRC,
               "-o", os.path.join(tmp, "lib.so"), "-ljpeg", "-lpng",
               "-lpthread"]
        try:
            run = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            return str(e)
        if run.returncode == 0:
            return "g++ builds it, and the library does not load"
        return run.stderr.strip() or f"g++ exited {run.returncode}"


def _loads(so):
    """Whether the library file loads, tried in a process of its own: a
    truncated ELF can kill the process that maps it (SIGBUS)."""
    run = subprocess.run([sys.executable, "-c",
                          "import ctypes, sys; ctypes.CDLL(sys.argv[1])", so],
                         capture_output=True, timeout=60)
    return run.returncode == 0


def jax_native_loader_ready():
    """True once the JAX package's native loader is loaded in this process;
    skips the calling test where it does not build here. Call it only in a
    fixture. The JAX module caches a failed build for the life of the
    process, and a process loses its first build when another builds the
    same file at that moment (at collection, under pytest-xdist). Under a
    lock on native/build/ this removes a library there that does not load
    (a build cut short), clears the cached failure and builds or loads the
    library once more; the repaired module stays for the rest of the
    process."""
    if jnl.available():
        return True
    os.makedirs(jnl._BUILD, exist_ok=True)
    with open(os.path.join(jnl._BUILD, ".test_build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(jnl._SO) and not _loads(jnl._SO):
            os.remove(jnl._SO)
        jnl._lib, jnl._build_failed = None, False
        if jnl.available():
            return True
    pytest.skip("the JAX package's native loader does not build here "
                f"(retried under a lock): {_jax_build_error()}")


@pytest.fixture(scope="module")
def built():
    jax_native_loader_ready()
    assert tnl.available(), tnl.unavailable_reason()


def _write_png(path, arr, ctype, depth=8, palette=None, trns=None):
    """A PNG of colour type ctype (0 gray, 2 RGB, 3 palette, 4 gray + alpha,
    6 RGBA) and bit depth 8 or 16 from arr (H, W[, C]), filter None."""
    arr = np.asarray(arr)
    H, W = arr.shape[:2]
    raw = arr.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1)
    rows = b"".join(b"\0" + r.tobytes() for r in raw)
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))]
    if palette is not None:
        chunks.append((b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        chunks.append((b"tRNS", bytes(trns)))
    chunks += [(b"IDAT", zlib.compress(rows)), (b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(timg._PNG_SIG + b"".join(timg._chunk(k, d) for k, d in chunks))


def _files(root, H, W):
    """{name: (path, the uint8 pixels libpng / libjpeg give loader.cpp after
    png_set_expand, strip_16 and strip_alpha)}, H x W each."""
    rng = np.random.default_rng(H * 1000 + W)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = np.stack([np.sin(xx / 4), np.cos(yy / 6), np.sin((xx - yy) / 5)], -1)
    rgb = np.clip((smooth * 0.45 + 0.5) * 255 + rng.normal(0, 25, (H, W, 3)),
                  0, 255).astype(np.uint8)
    gray = rgb[..., 1]
    alpha = rng.integers(0, 256, (H, W), dtype=np.uint8)
    wide = rng.integers(0, 65536, (H, W, 3)).astype(np.uint16)
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    index = rng.integers(0, 16, (H, W)).astype(np.uint8)
    out = {}

    def add(name, pixels, write):
        path = os.path.join(root, f"{name}_{H}x{W}")
        path = write(path)
        out[name] = (path, np.ascontiguousarray(pixels))

    add("gray", gray, lambda p: _png(p, gray, 0))
    add("gray_alpha", gray, lambda p: _png(p, np.stack([gray, alpha], -1), 4))
    add("rgb", rgb, lambda p: _png(p, rgb, 2))
    add("rgba", rgb, lambda p: _png(p, np.concatenate(
        [rgb, alpha[..., None]], -1), 6))
    add("palette", palette[index], lambda p: _png(p, index, 3, palette=palette))
    add("palette_trns", palette[index], lambda p: _png(
        p, index, 3, palette=palette, trns=range(0, 256, 16)))
    add("rgb16", (wide >> 8).astype(np.uint8), lambda p: _png(p, wide, 2, 16))
    add("gray16", (wide[..., 0] >> 8).astype(np.uint8),
        lambda p: _png(p, wide[..., 0], 0, 16))
    jpg = os.path.join(root, f"jpeg_{H}x{W}.jpg")
    cv2.imwrite(jpg, rgb[..., ::-1])
    out["jpeg"] = (jpg, timg._jpeg_native(jpg, False))
    return out


def _png(path, arr, ctype, depth=8, palette=None, trns=None):
    path += ".png"
    _write_png(path, arr, ctype, depth, palette, trns)
    return path


@pytest.mark.parametrize("H,W,size", [(64, 64, 32), (40, 40, 40),
                                      (48, 40, 29), (44, 60, 32),
                                      (30, 36, 50)])
def test_decode_image_matches_jax_and_plain(tmp_path, built, H, W, size):
    """Integer, unit, non-integer and upsampling ratios, square and not."""
    for name, (path, pixels) in _files(str(tmp_path), H, W).items():
        for mode in MODES:
            got = tnl.decode_image(path, size, mode)
            want = jnl.decode_image(path, size, mode)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {mode}")
            np.testing.assert_array_equal(
                tnl.decode_image_plain(pixels, size, mode), got,
                err_msg=f"{name} {mode} plain")


def test_decode_image_plain_refuses_other_inputs():
    for bad in (np.zeros((4, 4, 2), np.uint8), np.zeros((4, 4, 3), np.float32)):
        with pytest.raises(ValueError):
            tnl.decode_image_plain(bad, 2)
    with pytest.raises(ValueError):
        tnl.decode_image_plain(np.zeros((4, 4, 3), np.uint8), 2, 3)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_batcher_matches_jax(tmp_path, built, threads, mode):
    files = _files(str(tmp_path), 48, 40)
    paths = [p for p, _ in files.values()]
    order = [3, 0, 8, 5, 5, 1]
    got, want = (pkg.NativeBatcher(paths, 29, mode, threads)
                 for pkg in (tnl, jnl))
    for batch in (order, [2, 7]):
        got.submit(batch)
        want.submit(batch)
        a, b = got.wait(), want.wait()
        np.testing.assert_array_equal(a, b)
        for j, i in enumerate(batch):
            np.testing.assert_array_equal(a[j], tnl.decode_image(paths[i], 29, mode))
    got.close()
    want.close()


def test_batcher_errors_match_jax(tmp_path, built):
    """A file that fails counts one error in wait; an out-of-range index is
    refused at submit and leaves the pool usable; the same in both."""
    files = _files(str(tmp_path), 16, 16)
    bad = str(tmp_path / "corrupt.png")
    with open(bad, "wb") as f:
        f.write(b"\x89Pnotapng")
    paths = [files["rgb"][0], bad, str(tmp_path / "missing.png")]
    for pkg in (tnl, jnl):
        b = pkg.NativeBatcher(paths, 16, pkg.MODE_RGB, threads=2)
        b.submit([0, 1])
        with pytest.raises(IOError, match="^1 decode errors"):
            b.wait()
        b.submit([1, 2, 0])
        with pytest.raises(IOError, match="^2 decode errors"):
            b.wait()
        with pytest.raises(RuntimeError, match=r"\(-2\)"):
            b.submit([0, 3])
        b.submit([0, 0])
        np.testing.assert_array_equal(
            b.wait(), np.stack([tnl.decode_image(paths[0], 16)] * 2))
        b.close()
        for p in paths[1:]:
            with pytest.raises(IOError):
                pkg.decode_image(p, 16)


def test_undecodable_file_falls_back_to_opencv(tmp_path, built):
    """A BMP: loader.cpp refuses it (IOError), and both packages' load_*
    decode it by OpenCV's rules instead, to the same arrays."""
    files = _files(str(tmp_path), 40, 48)
    rgb = files["rgb"][1]
    bmp = str(tmp_path / "x.bmp")
    cv2.imwrite(bmp, rgb[..., ::-1])
    for pkg in (tnl, jnl):
        with pytest.raises(IOError):
            pkg.decode_image(bmp, 32)
    tds.reset_decode_routes()
    np.testing.assert_array_equal(tds.load_image(bmp, 32), jds.load_image(bmp, 32))
    np.testing.assert_array_equal(tds.load_mask(bmp, 32), jds.load_mask(bmp, 32))
    for a, b in zip(tds.load_iuv(bmp, 32), jds.load_iuv(bmp, 32)):
        np.testing.assert_array_equal(a, b)
    tds.load_image(files["rgb"][0], 32)
    assert dict(tds.decode_routes) == {"cv2": 3, "native": 1}


def test_unavailable_library_falls_back_and_says_why(tmp_path, monkeypatch,
                                                     capsys):
    """Without the library the port decodes by OpenCV's rules and prints
    the reason once."""
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, np.full((20, 24, 3), 77, np.uint8))
    monkeypatch.setattr(tnl, "_load", lambda: (None, "no g++ to build it"))
    tds.reset_decode_routes()
    for _ in range(2):
        tds.load_image(path, 16)
    err = capsys.readouterr().err
    assert err.count("[data] native loader unavailable: no g++ to build it; "
                     "decoding with OpenCV") == 1
    assert dict(tds.decode_routes) == {"cv2": 2}
    with pytest.raises(RuntimeError, match="no g\\+\\+ to build it"):
        tnl.NativeBatcher([path], 16)


_BUILD_ONE = """
import sys
from pathlib import Path
from neural_human_video_rendering_tpu_torch.data import native_loader as nl
nl._BUILD = Path(sys.argv[1])
print(nl.available(), nl.library_path(), nl.unavailable_reason())
"""


def test_concurrent_first_build(tmp_path, built):
    """Four processes building into an empty dir at once: each loads a
    whole library, and one file is left with no temporary beside it."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1 and lines.pop().startswith(f"True {tmp_path}/")
    assert [f.name for f in tmp_path.iterdir()] == [tnl.library_path().name]


def test_the_port_builds_its_own_copy():
    """The C++ the port builds lies inside its package, is not the JAX
    package's file, and below its header comment is the same code."""
    src = tnl._SRC.resolve()
    assert PORT in src.parents and src.is_file()
    assert tnl.library_path().parent == REPO / "build" / "native"
    ours, theirs = src.read_text(), (REPO / "native" / "loader.cpp").read_text()
    assert ours != theirs
    body = "#include <atomic>"
    assert ours[ours.index(body):] == theirs[theirs.index(body):]
    assert "-ffp-contract=off" in tnl._GXX_FLAGS


def _poison(monkeypatch):
    """The JAX module as a process that lost a concurrent first build
    leaves it: no library, and the failure cached."""
    monkeypatch.setattr(jnl, "_lib", None)
    monkeypatch.setattr(jnl, "_build_failed", True)
    assert not jnl.available()


def _ready():
    """jax_native_loader_ready() where `built` has shown that the library
    builds: a skip from it is a failure here."""
    try:
        return jax_native_loader_ready()
    except pytest.skip.Exception as e:
        pytest.fail(f"jax_native_loader_ready skipped: {e}")


def test_ready_repairs_a_cached_build_failure(tmp_path, built, monkeypatch):
    """After the JAX module cached a failed build, the helper loads the
    library again, and the JAX package decodes bit for bit as the port."""
    _poison(monkeypatch)
    assert _ready() is True
    assert jnl.available() and not jnl._build_failed
    for name, (path, _) in _files(str(tmp_path), 48, 40).items():
        for mode in MODES:
            np.testing.assert_array_equal(jnl.decode_image(path, 29, mode),
                                          tnl.decode_image(path, 29, mode),
                                          err_msg=f"{name} {mode}")


@pytest.mark.parametrize("keep", [64, 4096])
def test_ready_rebuilds_a_truncated_library(tmp_path, built, monkeypatch,
                                            keep):
    """A library file newer than the source that does not load (a build cut
    short: dlopen refuses 64 bytes, and dies of SIGBUS on 4096) is removed
    under the lock and built anew."""
    so = tmp_path / "libnhvr_loader.so"
    so.write_bytes(Path(jnl._SO).read_bytes()[:keep])
    assert not _loads(str(so))
    monkeypatch.setattr(jnl, "_BUILD", str(tmp_path))
    monkeypatch.setattr(jnl, "_SO", str(so))
    _poison(monkeypatch)
    assert _ready() is True
    assert so.stat().st_size > keep and _loads(str(so))
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        ".test_build.lock", so.name]
    (tmp_path / "img").mkdir()
    path = _files(str(tmp_path / "img"), 16, 16)["rgb"][0]
    np.testing.assert_array_equal(jnl.decode_image(path, 16),
                                  tnl.decode_image(path, 16))


_POISONED_RUN = """
import sys
import pytest
from neural_human_video_rendering_tpu.data import native_loader as nl
nl._build_failed, nl._lib = True, None
sys.exit(pytest.main(["-q", "-rs", "-p", "no:cacheprovider", "-p", "no:xdist",
                      *sys.argv[1:]]))
"""


def test_poisoned_collection_still_runs_the_native_cases(built):
    """pytest started with the JAX module poisoned before collection, as a
    worker that lost the build race at collection is: a case under
    `built` and a native case of the real-data tests pass, none skips."""
    cases = ["tests/test_torch_port_native_loader.py::"
             "test_batcher_errors_match_jax",
             "tests/test_torch_port_data_real.py::"
             "test_loaders_resize_match_jax[native-48-40]"]
    run = subprocess.run([sys.executable, "-c", _POISONED_RUN, *cases],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    tail = run.stdout.strip().splitlines()[-1]
    assert run.returncode == 0 and tail.startswith("2 passed"), run.stdout
    assert "skipped" not in run.stdout, run.stdout
