#!/usr/bin/env python3
"""Device time of every distinct convolution of a configuration's stage-2
step in both memory layouts, NCHW against NHWC (channels_last), so that a
layout rule can be read off the card:

    python3 -m neural_human_video_rendering_tpu_torch.conv_layout_ab \\
        perfbench/configs/flagship512.json perfbench/configs/local1024.json

Each argument is a JSON file whose ``flags`` are the port's Options (a
benchmark configuration). The shapes are those of the step's networks at
its batch: TransG, TexG, BGNet, each scale of D on the pose and a frame,
and the VGG on a frame, recorded by running the networks once on the meta
device. For each distinct (conv, input shape) the conv runs as
``models/layers.py`` runs it, bf16 activations and the float32 weight cast
each call, with its input, weight and output gradient all NCHW or all
NHWC: the forward alone, then the forward and both input and weight
gradients, each timed as chip_smoke's kernels are (20 calls in one CUDA
graph, replayed between CUDA events), and cuDNN's layout changes in the
forward and gradients counted by the profiler (``moves_*``). The
InstanceNorm of the conv's output, forward and backward, is timed the
same way: NCHW as autograd
takes the formula, NHWC as ``models/layers.InstanceNorm`` runs it on the
card. Prints one JSON line a shape, then a summary line per configuration
(the sums over its convs, each shape times its calls, and the shapes
where NHWC is slower); exits non-zero without a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def conv_shapes(torch, flags):
    """The distinct convs of one step's networks: a dict keyed by (kind,
    input shape, weight shape, stride, padding, output_padding) -> the
    networks that run it and how many times one forward of each does."""
    from neural_human_video_rendering_tpu_torch.config import Options
    from neural_human_video_rendering_tpu_torch.models import layers
    from neural_human_video_rendering_tpu_torch.models.discriminator import \
        discriminator_from_options
    from neural_human_video_rendering_tpu_torch.models.renderer import \
        renderer_from_options
    from neural_human_video_rendering_tpu_torch.models.vgg import \
        VGG19Features
    opt = Options(**flags)
    opt.isTrain = True
    B, S = opt.batchSize, opt.train_size
    g = renderer_from_options(opt)
    d = discriminator_from_options(opt)
    with torch.device("meta"):
        vgg = VGG19Features(dtype=torch.bfloat16)
        pose = torch.empty(B, opt.pose_nc, S, S)
        frame = torch.empty(B, 3, S, S)
    found = {}
    net = [""]

    def hook(m, args):
        x = args[0]
        transposed = isinstance(m, layers.ConvTranspose)
        key = ("deconv" if transposed else "conv", tuple(x.shape),
               tuple(m.weight.shape), m.stride[0], m.padding[0],
               m.output_padding[0] if transposed else 0)
        entry = found.setdefault(key, {})
        entry[net[0]] = entry.get(net[0], 0) + 1

    for m in (*g.modules(), *d.modules(), *vgg.modules()):
        if isinstance(m, (layers.Conv, layers.ConvTranspose)):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        for name, fn in (("TransG", lambda: g.TransG(pose)),
                         ("TexG", lambda: g.TexG(pose)),
                         ("BGNet", lambda: g.BGNet(frame[:1])),
                         ("D", lambda: d(torch.cat([pose, frame], 1))),
                         ("VGG", lambda: vgg(frame))):
            net[0] = name
            fn()
    return found


def layout_kernels(torch, fn) -> int:
    """cuDNN's layout changes (nchwToNhwc / nhwcToNchw kernels) one call
    of fn launches, by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "nchwToNhwc" in e.key or "nhwcToNchw" in e.key)


def time_shape(torch, smoke, key, dev):
    """{fwd,train,norm}_{nchw,nhwc}_ms of one conv shape (module doc)."""
    import torch.nn.functional as F
    from neural_human_video_rendering_tpu_torch.models.layers import \
        InstanceNorm
    nhwc_norm = InstanceNorm()
    kind, xs, ws, stride, pad, out_pad = key
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, fmt in (("nchw", torch.contiguous_format),
                      ("nhwc", torch.channels_last)):
        x = torch.randn(xs, device=dev, generator=gen).to(
            torch.bfloat16, memory_format=fmt).requires_grad_()
        w = (torch.randn(ws, device=dev, generator=gen) * 0.05).contiguous(
            memory_format=fmt).requires_grad_()
        b = torch.zeros(ws[1] if kind == "deconv" else ws[0], device=dev,
                        requires_grad=True)

        def conv():
            if kind == "deconv":
                return F.conv_transpose2d(x, w.to(x.dtype), b.to(x.dtype),
                                          stride=stride, padding=pad,
                                          output_padding=out_pad)
            return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), stride=stride,
                            padding=pad)

        with torch.no_grad():
            y = conv()
        gy = torch.randn(y.shape, device=dev, generator=gen).to(
            torch.bfloat16, memory_format=fmt)

        def fwd():
            with torch.no_grad():
                conv()

        def train():
            torch.autograd.grad(conv(), (x, w, b), gy)

        gn = gy
        if kind == "deconv" and pad == 0:      # pad "same": the crop
            y = y[:, :, :2 * xs[2], :2 * xs[3]]
            gn = gy[:, :, :2 * xs[2], :2 * xs[3]].contiguous(
                memory_format=fmt)
        yn = y.detach().requires_grad_()

        def norm():
            if name == "nhwc":              # the port's, on the card
                z = nhwc_norm(yn)
            else:                           # the NCHW formula, by autograd
                yf = yn.float()
                mean = yf.mean(dim=(2, 3), keepdim=True)
                var = torch.clamp((yf * yf).mean(dim=(2, 3), keepdim=True)
                                  - mean * mean, min=0.0)
                z = ((yf - mean) * torch.rsqrt(var + 1e-5)).to(yn.dtype)
            torch.autograd.grad(z, yn, gn)

        out[f"fwd_{name}_ms"] = smoke.graph_ms(torch, fwd)
        out[f"train_{name}_ms"] = smoke.graph_ms(torch, train)
        out[f"norm_{name}_ms"] = smoke.graph_ms(torch, norm)
        out[f"moves_{name}"] = layout_kernels(torch, train)
        del x, w, b, y, gy, gn, yn
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="+",
                    help="JSON files holding the port's flags under 'flags'")
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch
    if not torch.cuda.is_available():
        print("conv_layout_ab: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    times = {}
    for path in args.configs:
        with open(path) as f:
            cfg = json.load(f)
        name = cfg.get("name", os.path.basename(path))
        shapes = conv_shapes(torch, cfg["flags"])
        sums = {}
        slower = []
        for key, nets in sorted(shapes.items()):
            if key not in times:
                times[key] = time_shape(torch, smoke, key, dev)
            t = times[key]
            calls = sum(nets.values())
            for k, v in t.items():
                sums[k] = sums.get(k, 0.0) + v * calls
            if t["train_nhwc_ms"] > t["train_nchw_ms"] \
                    or t["fwd_nhwc_ms"] > t["fwd_nchw_ms"]:
                slower.append(list(key))
            print(json.dumps({"config": name, "kind": key[0],
                              "input": key[1], "weight": key[2],
                              "stride": key[3], "padding": key[4],
                              "output_padding": key[5], "nets": nets,
                              **t}), flush=True)
        print(json.dumps({"config": name, "card": card,
                          "shapes": len(shapes),
                          "sums_ms": {k: round(v, 4) for k, v in
                                      sorted(sums.items())},
                          "nhwc_slower": slower}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
