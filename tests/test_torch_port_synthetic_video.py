"""PyTorch port, the learnable corpus against the JAX package on the CPU:
every function of ``data/synthetic_video.py`` and ``data/corruption.py``
on the same joints (from the port's SyntheticDataset), ``write_corpus``'s
trees, make_demo_data's command line, and the bilinear corpus rendered by
the port's texture warp.

Tolerances: integers exactly, floats within 1e-6 (the same numpy
arithmetic; in practice equal), the corruptions bit-equal (the same
RandomState streams and OpenCV calls), the written trees: the same file
lists, equal decoded images and keypoints, equal .flo bytes. The bilinear
oracle: the warp's plain version against the corpus frame within 1e-5,
the JAX package's own bound (tests/test_synthetic_video.py).
"""

import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

from neural_human_video_rendering_tpu.data import corruption as jcr
from neural_human_video_rendering_tpu.data import synthetic_video as jsv
from neural_human_video_rendering_tpu_torch import make_demo_data
from neural_human_video_rendering_tpu_torch.config import Options
from neural_human_video_rendering_tpu_torch.data import corruption as tcr
from neural_human_video_rendering_tpu_torch.data import synthetic_video as tsv
from neural_human_video_rendering_tpu_torch.data.dataset import (
    SyntheticDataset, list_images)
from neural_human_video_rendering_tpu_torch.data.keypoints import (
    BODY25_TO_COCO18, write_keypoint_json)
from neural_human_video_rendering_tpu_torch.ops.texture_warp import \
    texture_warp_planes
from neural_human_video_rendering_tpu_torch.utils.image import read_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_TOL = 1e-6
ORACLE_TOL = 1e-5
S, T = 64, 16


@pytest.fixture(scope="module")
def joints():
    """(6, 18, 3) joints of the port's SyntheticDataset on the S canvas."""
    raw = SyntheticDataset(Options(loadSize=256), length=6, seed=0).joints
    return tsv.fit_canvas_joints(raw.astype(np.float32), S)


def _same(a, b):
    """Equal structure; integers exactly, floats within FLOAT_TOL."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, atol=FLOAT_TOL, rtol=0)


def _calls(j):
    parts, uv, limb = jsv.rasterize_iuv(j[2], S)
    atlas, bg = jsv.part_texture_atlas(tile=T), jsv.background_image(S)
    return {
        "constants": lambda m: (m.LIMB_TO_PART, np.float64(m.LIMB_RADIUS)),
        "part_texture_atlas": lambda m: m.part_texture_atlas(tile=T),
        "background_image": lambda m: m.background_image(S),
        "fit_canvas_joints": lambda m: m.fit_canvas_joints(j * 3.0 + 7.0, S),
        "rasterize_iuv": lambda m: m.rasterize_iuv(j[2], S),
        "render_frame_nearest": lambda m: m.render_frame(parts, uv, atlas, bg),
        "render_frame_bilinear": lambda m: m.render_frame(
            parts, uv, atlas, bg, "bilinear"),
        "limb_flow": lambda m: m.limb_flow(j[3], j[2], limb),
        "person_variant_seed0": lambda m: m.person_variant(j, S, 0),
        "person_variant_seed3": lambda m: m.person_variant(j, S, 3),
    }


@pytest.mark.parametrize("name", [
    "constants", "part_texture_atlas", "background_image", "fit_canvas_joints",
    "rasterize_iuv", "render_frame_nearest", "render_frame_bilinear",
    "limb_flow", "person_variant_seed0", "person_variant_seed3"])
def test_synthetic_video_matches_jax(joints, name):
    call = _calls(joints)[name]
    _same(call(tsv), call(jsv))


def test_load_reference_joints_matches_jax(tmp_path, joints):
    kp = str(tmp_path / "kp")
    _write_keypoints(kp, joints * 4.0)
    _same(tsv.load_reference_joints(kp, S), jsv.load_reference_joints(kp, S))


def _corruptions(j):
    parts, uv, _ = jsv.rasterize_iuv(j[2], S)
    mask = (parts > 0).astype(np.float32)
    masks_sum = sum((jsv.rasterize_iuv(x, S)[0] > 0).astype(np.float32)
                    for x in j)
    occ = jcr.occupancy(masks_sum, len(j))
    bg = jsv.background_image(S)
    return {
        "corrupt_mask": lambda m, s: m.corrupt_mask(mask, 3, 2, s),
        "corrupt_iuv": lambda m, s: m.corrupt_iuv(parts, uv, 3, 2, s),
        "occupancy": lambda m, s: m.occupancy(masks_sum * s, len(j)),
        "corrupt_bg": lambda m, s: m.corrupt_bg(bg, occ, 3, s),
    }


@pytest.mark.parametrize("strength", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("name", ["corrupt_mask", "corrupt_iuv", "occupancy",
                                  "corrupt_bg"])
def test_corruption_is_bit_equal_to_jax(joints, name, strength):
    call = _corruptions(joints)[name]
    got, want = call(tcr, strength), call(jcr, strength)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    if strength > 0 and name == "corrupt_mask":
        assert not np.array_equal(got, call(tcr, 0.0))


def _write_keypoints(d, joints):
    os.makedirs(d, exist_ok=True)
    for i, j in enumerate(joints):
        body = np.zeros((25, 3), np.float32)
        body[BODY25_TO_COCO18] = j
        write_keypoint_json(os.path.join(d, f"frame{i:05d}_keypoints.json"),
                            body)


def _same_tree(a, b):
    """The same files; images decode equal, everything else byte-equal
    (.flo flows, keypoint JSONs, cuts.json, .npy)."""
    fa = sorted(os.path.relpath(os.path.join(r, f), a)
                for r, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(r, f), b)
                for r, _, fs in os.walk(b) for f in fs)
    assert fa == fb
    for f in fa:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith((".png", ".jpg")):
            np.testing.assert_array_equal(read_image(pa, "rgb"),
                                          read_image(pb, "rgb"), err_msg=f)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), f
    return fa


@pytest.mark.parametrize("corrupt,cuts,sampling,laplace_ch", [
    (0.0, (), "nearest", 0),
    (0.5, (3,), "bilinear", 2),
])
def test_write_corpus_matches_jax(tmp_path, joints, corrupt, cuts, sampling,
                                  laplace_ch):
    kw = dict(size=S, tile=T, laplace_ch=laplace_ch, cuts=cuts,
              corrupt=corrupt, corrupt_seed=1, sampling=sampling)
    pt = tsv.write_corpus(str(tmp_path / "t"), joints, **kw)
    pj = jsv.write_corpus(str(tmp_path / "j"), joints, **kw)
    assert {k: os.path.relpath(v, str(tmp_path / "t")) for k, v in pt.items()
            } == {k: os.path.relpath(v, str(tmp_path / "j"))
                  for k, v in pj.items()}
    files = _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    assert sum(f.endswith(".flo") for f in files) == 2 * (len(joints) - 1)
    assert ("cuts.json" in files) == bool(cuts)
    if cuts:
        with open(os.path.join(tmp_path, "t", "cuts.json")) as f:
            assert json.load(f) == {"cuts": list(cuts)}


def test_bilinear_frame_is_the_warp_of_its_iuv(joints):
    """A bilinear corpus frame is the renderer's equation on its own IUV:
    the port's texture warp (the plain version on the CPU) with the frame's
    one-hot part map, its uv tiled over the parts and the atlas, then the
    composite with the mask and bg, gives the frame back within 1e-5."""
    parts, uv, _ = tsv.rasterize_iuv(joints[1], S)
    atlas, bg = tsv.part_texture_atlas(tile=T), tsv.background_image(S)
    frame, mask = tsv.render_frame(parts, uv, atlas, bg, "bilinear")
    nearest, _ = tsv.render_frame(parts, uv, atlas, bg, "nearest")
    P = atlas.shape[0]
    tex = torch.from_numpy(atlas).permute(0, 3, 1, 2)[None]       # 1,P,3,T,T
    uvt = torch.from_numpy(uv).permute(2, 0, 1)[None, None].expand(
        1, P, 2, S, S)
    probs = torch.from_numpy(np.eye(P + 1, dtype=np.float32)[parts]).permute(
        2, 0, 1)[None]
    with torch.no_grad():
        fg = texture_warp_planes(tex, uvt, probs, k=4, eps=1e-3)
    fg = fg[0].permute(1, 2, 0).numpy()
    composite = mask * fg + (1 - mask) * bg
    np.testing.assert_allclose(composite, frame, atol=ORACLE_TOL, rtol=0)
    assert np.abs(nearest - frame).max() > 0.01


def test_make_demo_data_matches_the_jax_tool(tmp_path, monkeypatch, joints):
    """The same argv through the port's entry point and the JAX package's
    tools/make_demo_data.py write the same tree."""
    kp = str(tmp_path / "kp")
    _write_keypoints(kp, joints)
    argv = ["--size", str(S), "--tile", str(T), "--keypoints", kp,
            "--people", "2", "--repeat", "2", "--corrupt", "0.3",
            "--corrupt_seed", "4", "--sampling", "bilinear"]
    assert make_demo_data.main(argv + ["--out", str(tmp_path / "t")]) == 0
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import make_demo_data as jtool
    monkeypatch.setattr(sys, "argv", ["make_demo_data.py"] + argv
                        + ["--out", str(tmp_path / "j")])
    jtool.main()
    files = _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    assert len(list_images(str(tmp_path / "t" / "frames"))) == 2 * 2 * 6
    assert "cuts.json" in files
    with pytest.raises(FileNotFoundError, match="nowhere"):
        make_demo_data.main(["--out", str(tmp_path / "x"), "--keypoints",
                             str(tmp_path / "nowhere")])


def test_write_corpus_refuses_without_opencv(tmp_path, monkeypatch, joints):
    """write_corpus writes through OpenCV, as the JAX package does; where
    cv2 does not import it refuses before writing anything, naming the
    package that fixes it."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="opencv-python"):
        tsv.write_corpus(str(tmp_path / "c"), joints, size=S, tile=T)
    assert not (tmp_path / "c").exists()
