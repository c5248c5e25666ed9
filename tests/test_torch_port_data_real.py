"""PyTorch port, real data: the port's FrameDataset against the JAX
package's on a tiny corpus in the reference directory layout, the port's
image decoding against OpenCV, BatchLoader, and the densepose / laplace
copies.

Every test runs on both decode routes (the ``route`` fixture): OpenCV's
rules ("cv2": INTER_AREA for images, INTER_NEAREST for masks and IUV) or
the native loader ("native": native/loader.cpp's bilinear resize, soft
masks, its own nearest rule), each forced on both packages at once by
patching their ``native_loader.available``; the native cases skip where
the JAX package's library does not build, once a build lost to another
test process has been retried (jax_native_loader_ready). The corpus is
written with cv2 from the JAX package's SyntheticDataset samples, at
loadSize (32 px), so no resize runs, and at 48 px for the cases that
resize; the loader cases resize 48x40 and 96x96 sources to 32; evaluate
scores 48 px frames at 32.
The scale_width corpus is 32 wide and 24 high: no resize, the canvas
pads (OpenCV's rules on both routes, as in the JAX package). Exact
equality everywhere in this file, except the JPEG decode (libjpeg
against OpenCV's, within 1 level) and evaluate's metrics (PSNR within
1e-4 dB and SSIM within 1e-5, each framework's float32 arithmetic on
bit-equal decoded frames).
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.config import Options as JOptions
from neural_human_video_rendering_tpu.data import dataset as jds
from neural_human_video_rendering_tpu.data import densepose as jdp
from neural_human_video_rendering_tpu.data import keypoints as jkp
from neural_human_video_rendering_tpu.data import laplace as jlp
from neural_human_video_rendering_tpu.infer import evaluate as jev
from neural_human_video_rendering_tpu_torch.config import Options as TOptions
from neural_human_video_rendering_tpu_torch.data import dataset as tds
from neural_human_video_rendering_tpu_torch.data import densepose as tdp
from neural_human_video_rendering_tpu_torch.data import laplace as tlp
from neural_human_video_rendering_tpu_torch.infer import evaluate as tev
from neural_human_video_rendering_tpu_torch.utils import image as timg
from test_torch_port_native_loader import jax_native_loader_ready

N = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's CPU thread pool slows many-fold when they share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, params=["cv2", "native"])
def route(request, monkeypatch):
    """Both packages decode by one route: OpenCV's rules ("cv2") or the
    native loader ("native"; skipped where the JAX package's loader does
    not build on this host)."""
    native = request.param == "native"
    if native:
        jax_native_loader_ready()
    for nl in (jds.nl, tds.nl):
        monkeypatch.setattr(nl, "available", lambda: native)
    tds.reset_decode_routes()
    return request.param


def _write_flo(path, fl):
    with open(path, "wb") as f:
        f.write(np.float32(202021.25).tobytes())
        f.write(np.int32(fl.shape[1]).tobytes())
        f.write(np.int32(fl.shape[0]).tobytes())
        f.write(fl.astype(np.float32).tobytes())


def write_corpus(root, S=32, H=None, cuts=(6,)):
    """Keypoint JSONs, frames, masks, IUV, .npy flows and .flo inverse
    flows of N frames of the JAX SyntheticDataset, W=S by H (default S)
    pixels, plus bg.png and cuts.json; returns the dirs as flags."""
    H = H or S
    syn = jds.SyntheticDataset(JOptions(loadSize=S), length=N, seed=3)
    dirs = {k: os.path.join(root, k) for k in
            ("kp", "frames", "mask", "dp", "flow", "flow_inv")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(N):
        s = syn[i]
        body = np.zeros((25, 3), np.float32)
        body[jkp.BODY25_TO_COCO18] = s["joints"]
        body[jkp.BODY25_TO_COCO18[3], 2] = 0.0          # one joint missing
        jkp.write_keypoint_json(os.path.join(dirs["kp"],
                                             f"frame{i:05d}_keypoints.json"), body)
        img = np.round((s["image"][:H] + 1) * 127.5).astype(np.uint8)
        cv2.imwrite(os.path.join(dirs["frames"], f"frame{i:05d}.png"),
                    img[..., ::-1])
        cv2.imwrite(os.path.join(dirs["mask"], f"frame{i:05d}.png"),
                    (s["mask"][:H, :, 0] * 255).astype(np.uint8))
        iuv = jdp.encode_iuv(s["dp_parts"][:H], s["dp_uv"][:H])
        cv2.imwrite(os.path.join(dirs["dp"], f"frame{i:05d}.png"),
                    iuv[..., ::-1])
        if i + 1 < N:
            fl = np.random.default_rng(i).normal(0, 2, (H, S, 2))
            np.save(os.path.join(dirs["flow"], f"{i:05d}.npy"),
                    fl.astype(np.float32))
            _write_flo(os.path.join(dirs["flow_inv"], f"{i:05d}.flo"), -fl)
    cv2.imwrite(os.path.join(root, "bg.png"),
                np.round((syn.background()[:H] + 1) * 127.5).astype(np.uint8))
    with open(os.path.join(root, "cuts.json"), "w") as f:
        json.dump({"cuts": list(cuts)}, f)
    return dict(pose_path=dirs["kp"], img_path=dirs["frames"],
                mask_path=dirs["mask"], densepose_path=dirs["dp"],
                flow_path=dirs["flow"], flow_inv_path=dirs["flow_inv"],
                bg_path=os.path.join(root, "bg.png"))


def _assert_items_equal(jd, td):
    assert len(td) == len(jd)
    for k in range(len(jd)):
        a, b = jd[k], td[k]
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(np.asarray(b[key]),
                                          np.asarray(a[key]), err_msg=key)
            assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype, key


@pytest.mark.parametrize("mode,H,phase,ratio", [
    ("resize", 32, "train", 1.0), ("resize", 32, "train", 0.8),
    ("resize", 32, "test", 0.8), ("scale_width", 24, "train", 1.0),
    ("scale_width", 24, "test", 0.7)])
def test_frame_dataset_matches_jax(tmp_path, mode, H, phase, ratio):
    flags = write_corpus(str(tmp_path), H=H)
    common = dict(loadSize=32, resize_or_crop=mode, no_flip=True,
                  data_ratio=ratio, **flags)
    jd = jds.FrameDataset(JOptions(**common), phase)
    td = tds.FrameDataset(TOptions(**common), phase)
    assert list(td.indices) == list(jd.indices)
    assert td.cuts == jd.cuts == {6}
    _assert_items_equal(jd, td)
    if phase == "train":
        first = td[0]
        assert first["index"] == 0
        assert not first["flow"].any() and not first["flow_inv"].any()
        np.testing.assert_array_equal(first["joints_prev"], first["joints"])
        cut = td[6]          # a cut restarts the sequence
        assert not cut["flow"].any()
        np.testing.assert_array_equal(cut["joints_prev"], cut["joints"])
        assert td[7]["flow"].any()


def test_frame_dataset_flip_code_matches_jax(tmp_path):
    """The flip augmentation (the trainer refuses it for now; the host code
    is ported): the same samples flipped for the same (seed, epoch)."""
    flags = write_corpus(str(tmp_path))
    common = dict(loadSize=32, no_flip=False, **flags)
    jd = jds.FrameDataset(JOptions(**common), "train")
    td = tds.FrameDataset(TOptions(**common), "train")
    jd.epoch = td.epoch = 3
    _assert_items_equal(jd, td)


def test_frame_dataset_without_modalities_raises(tmp_path):
    with pytest.raises(ValueError):
        tds.FrameDataset(TOptions(pose_path=str(tmp_path / "none")))


def _png_image(C, seed):
    rng = np.random.default_rng(seed)
    ramp = (np.add.outer(np.arange(19), np.arange(23)) * 7 % 256).astype(np.uint8)
    chans = [ramp, rng.integers(0, 256, ramp.shape, dtype=np.uint8),
             ramp[::-1], ramp[:, ::-1]]
    return ramp if C == 1 else np.stack(chans[:C], -1)


_FILTERS = ("NONE", "SUB", "UP", "AVG", "PAETH")


@pytest.mark.parametrize("filt", _FILTERS + ("ALL",))
@pytest.mark.parametrize("C", [1, 3, 4])
def test_png_reader_matches_cv2(tmp_path, C, filt):
    """The port's PNG reader against cv2.imread on what cv2 writes with
    each scanline filter (ALL: libpng's adaptive choice per row)."""
    img = _png_image(C, C)
    flag = (cv2.IMWRITE_PNG_ALL_FILTERS if filt == "ALL"
            else getattr(cv2, f"IMWRITE_PNG_FILTER_{filt}"))
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, flag])
    got = timg.read_png(path)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if C > 1:
        ref = ref[..., [2, 1, 0, 3][:C]]
    np.testing.assert_array_equal(got, ref.reshape(got.shape))


@pytest.mark.parametrize("C", [1, 3, 4])
def test_read_image_without_cv2_matches_cv2(tmp_path, monkeypatch, C):
    """read_image's own PNG path (OpenCV absent) against its cv2 path."""
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, _png_image(C, 7), [cv2.IMWRITE_PNG_FILTER,
                                         cv2.IMWRITE_PNG_ALL_FILTERS])
    want = {m: timg.read_image(path, m) for m in ("rgb", "unchanged")}
    monkeypatch.setattr(timg, "_cv2", lambda: None)
    for m in ("rgb", "unchanged"):
        np.testing.assert_array_equal(timg.read_image(path, m), want[m])
    if C == 1:
        np.testing.assert_array_equal(timg.read_image(path, "gray"),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_jpeg_decoders(tmp_path, monkeypatch):
    """A JPEG without OpenCV: the libjpeg decoder (native/jpeg_decode.cpp)
    against cv2.imread; a file neither PNG nor JPEG is refused."""
    img = np.random.default_rng(0).integers(0, 256, (24, 40, 3), np.uint8)
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, img)
    ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    ref_gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    monkeypatch.setattr(timg, "_cv2", lambda: None)
    monkeypatch.setattr(timg, "_torchvision_io", lambda: None)
    got = timg.read_image(path, "rgb")
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref).max() <= 1
    assert np.abs(timg.read_image(path, "gray").astype(int) - ref_gray).max() <= 1
    assert "libjpeg" in timg.decoder_name()
    bmp = str(tmp_path / "x.bmp")
    cv2.imwrite(bmp, img)
    with pytest.raises(RuntimeError, match="PNG"):
        timg.read_image(bmp)


def test_loaders_match_jax(tmp_path):
    """load_image / load_mask / load_iuv / load_flow / load_texture_atlas
    with a resize (the route on both sides), and the .flo reader."""
    flags = write_corpus(str(tmp_path), S=32)
    f0 = os.path.join(flags["img_path"], "frame00003.png")
    m0 = os.path.join(flags["mask_path"], "frame00003.png")
    d0 = os.path.join(flags["densepose_path"], "frame00003.png")
    for size in (32, 20):
        np.testing.assert_array_equal(tds.load_mask(m0, size),
                                      jds.load_mask(m0, size))
        for a, b in zip(tds.load_iuv(d0, size), jds.load_iuv(d0, size)):
            np.testing.assert_array_equal(a, b)
        for name in ("00002.npy",):
            p = os.path.join(flags["flow_path"], name)
            np.testing.assert_array_equal(tds.load_flow(p, size),
                                          jds.load_flow(p, size))
    np.testing.assert_array_equal(tds.load_image(f0, 32), jds.load_image(f0, 32))
    flo = os.path.join(flags["flow_inv_path"], "00002.flo")
    np.testing.assert_array_equal(tds.read_flo(flo), jds.read_flo(flo))
    atlas = np.random.default_rng(1).integers(0, 256, (32, 48, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "atlas.png"), atlas)
    for tile in (8, 6):
        np.testing.assert_array_equal(
            tds.load_texture_atlas(str(tmp_path / "atlas.png"), tile),
            jds.load_texture_atlas(str(tmp_path / "atlas.png"), tile))


def _sources(root, H, W, seed=0):
    """An RGB frame (PNG and JPEG), a binary elliptical mask as gray and as
    RGB PNG, and an IUV map, H x W; returns their paths."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = np.stack([np.sin(xx / 5), np.cos(yy / 7), np.sin((xx + yy) / 9)], -1)
    rgb = np.clip((smooth * 0.4 + 0.5) * 255 + rng.normal(0, 20, (H, W, 3)),
                  0, 255).astype(np.uint8)
    ell = (((xx - W / 2) / (0.35 * W)) ** 2 + ((yy - H / 2) / (0.4 * H)) ** 2
           < 1).astype(np.uint8) * 255
    parts = np.where(ell > 0, rng.integers(1, 25, (H, W)), 0).astype(np.int32)
    uv = rng.uniform(0, 1, (H, W, 2)).astype(np.float32)
    p = {k: os.path.join(root, f"{k}_{H}x{W}.{ext}") for k, ext in (
        ("frame", "png"), ("jpeg", "jpg"), ("mask", "png"), ("mask_rgb", "png"),
        ("iuv", "png"))}
    cv2.imwrite(p["frame"], rgb[..., ::-1])
    cv2.imwrite(p["jpeg"], rgb[..., ::-1])
    cv2.imwrite(p["mask"], ell)
    cv2.imwrite(p["mask_rgb"], np.repeat(ell[..., None], 3, -1))
    cv2.imwrite(p["iuv"], jdp.encode_iuv(parts, uv)[..., ::-1])
    return p


@pytest.mark.parametrize("H,W", [(48, 40), (96, 96)])
def test_loaders_resize_match_jax(tmp_path, route, H, W):
    """Sources that resize to 32 (and to 20): load_image, load_mask and
    load_iuv bit-equal to the JAX package's on either route; the route
    shows in the masks (soft only on the native route) and is counted."""
    p = _sources(str(tmp_path), H, W)
    for size in (32, 20):
        for key in ("frame", "jpeg"):
            np.testing.assert_array_equal(tds.load_image(p[key], size),
                                          jds.load_image(p[key], size))
        for key in ("mask", "mask_rgb"):
            m = tds.load_mask(p[key], size)
            np.testing.assert_array_equal(m, jds.load_mask(p[key], size))
        for a, b in zip(tds.load_iuv(p["iuv"], size),
                        jds.load_iuv(p["iuv"], size)):
            np.testing.assert_array_equal(a, b)
    soft = tds.load_mask(p["mask"], 20)
    assert ((soft > 0) & (soft < 1)).any() == (route == "native")
    assert dict(tds.decode_routes) == {route: 11}


def test_frame_dataset_resized_matches_jax(tmp_path):
    """A 48 px corpus read at loadSize 32: every item of the port's
    FrameDataset bit-equal to the JAX package's, on either route."""
    flags = write_corpus(str(tmp_path), S=48)
    common = dict(loadSize=32, no_flip=True, **flags)
    jd = jds.FrameDataset(JOptions(**common), "train")
    td = tds.FrameDataset(TOptions(**common), "train")
    _assert_items_equal(jd, td)


def test_evaluate_resized_matches_jax(tmp_path):
    """evaluate on two dirs of 48 px frames scored at 32: the frames it
    scores bit-equal to the JAX package's, PSNR / SSIM within float32."""
    res, gt = str(tmp_path / "res"), str(tmp_path / "gt")
    for d, seed in ((res, 1), (gt, 2)):
        os.makedirs(d)
        for i in range(3):
            frame = cv2.imread(_sources(str(tmp_path), 48, 48, seed + 10 * i)
                               ["frame"])
            cv2.imwrite(os.path.join(d, f"frame{i:05d}.png"), frame)
    for d in (res, gt):
        names = sorted(os.listdir(d))
        np.testing.assert_array_equal(
            tev._load(d, names, 32, torch.device("cpu")).permute(0, 2, 3, 1).numpy(),
            np.stack([jds.load_image(os.path.join(d, n), 32) for n in names]))
    kw = dict(size=32, batch_size=2, use_vgg=False)
    want = jev.evaluate_dirs(res, gt, **kw)
    got = tev.evaluate_dirs(res, gt, device=torch.device("cpu"), **kw)
    assert got["frames"] == want["frames"] == 3
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5


class _Counting:
    def __init__(self, n):
        self.n = n
        self.epoch = -1
        self.seen = []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.seen.append(self.epoch)
        return {"x": np.full((2,), i, np.int32)}


@pytest.mark.parametrize("threads", [1, 3])
def test_batch_loader_tail_and_epochs(threads):
    ds = _Counting(7)
    loader = tds.BatchLoader(ds, 3, shuffle=True, seed=4, drop_last=False,
                             threads=threads)
    assert len(loader) == 3
    for epoch in range(2):
        batches = [b["x"][:, 0] for b in loader]
        assert [len(b) for b in batches] == [3, 3, 1]
        order = np.arange(7)
        np.random.RandomState(4 + epoch).shuffle(order)
        np.testing.assert_array_equal(np.concatenate(batches), order)
        assert set(ds.seen[-7:]) == {epoch}      # ds.epoch set each epoch
    assert loader.epoch == 2
    assert len(tds.BatchLoader(ds, 3)) == 2       # drop_last by default


def test_densepose_and_laplace_copies_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    iuv = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    iuv[..., 0] = rng.integers(0, 26, (9, 11))
    for a, b in zip(tdp.decode_iuv(iuv), jdp.decode_iuv(iuv)):
        np.testing.assert_array_equal(a, b)
    parts, uv = jdp.decode_iuv(iuv)
    np.testing.assert_array_equal(tdp.encode_iuv(parts, uv),
                                  jdp.encode_iuv(parts, uv))
    for a, b in zip(tdp.flip_iuv(parts, uv), jdp.flip_iuv(parts, uv)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdp.parts_one_hot(parts),
                                  jdp.parts_one_hot(parts))
    cv2.imwrite(str(tmp_path / "a.png"), iuv)
    cv2.imwrite(str(tmp_path / "g.png"), iuv[..., 0])
    np.save(tmp_path / "c.npy", rng.standard_normal((9, 11, 5)).astype(np.float32))
    assert tlp.list_frames(str(tmp_path)) == jlp.list_frames(str(tmp_path))
    for name, ch, size in (("a.png", 3, 16), ("g.png", 3, 0), ("c.npy", 5, 8)):
        np.testing.assert_array_equal(
            tlp.load_laplace(str(tmp_path / name), size, ch),
            jlp.load_laplace(str(tmp_path / name), size, ch))
    with pytest.raises(ValueError):
        tlp.load_laplace(str(tmp_path / "c.npy"), 8, 3)
