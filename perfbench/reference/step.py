"""The stage-2 train step and the rendering forward in plain PyTorch,
float32: a frozen copy of the port's step semantics.

One step: the wire batch dequantised, the pose input, frame t rendered
with gradient (and, under temporal_prev fake, frame t-1 rendered again
without it), each render handed its real frame, t or t-1, for G's
encoder E where the configuration has one (E's parameters are G's), D
frozen for G's loss (GAN, feature matching against D's detached real
features, VGG, L2, DensePose UV and part cross-entropy, the mask L1, the
flow-warped temporal L1), G's backward; then D's loss on the
detached fake with D's old parameters and its backward; Adam on both
(optax's form: eps added to the bias-corrected sqrt(v)); then the EMA of
G with the step count before the increment.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from . import nets
from .pose import pose_input
from .warp import flow_warp

U8_SYM = ("image", "image_prev", "bg")
U8_UNIT = ("mask", "dp_uv")
F16 = ("flow", "flow_inv")


def dequantize(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host wire batch (NHWC uint8 / float16 / float32 numpy) -> float32
    (int64 for dp_parts) NCHW tensors on `device`."""
    out = {}
    for k, a in batch.items():
        t = torch.as_tensor(np.asarray(a)).to(device)
        if k in U8_SYM:
            t = t.float() / 127.5 - 1.0
        elif k in U8_UNIT:
            t = t.float() / 255.0
        elif k == "dp_parts":
            t = t.long()
        else:
            t = t.float()
        if k in U8_SYM + U8_UNIT + F16:
            t = t.permute(0, 3, 1, 2)
        out[k] = t
    return out


def quantize(frames: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW frames -> uint8 NHWC."""
    q = torch.round((frames.clamp(-1.0, 1.0) + 1.0) * 127.5)
    return q.to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def _mse_to(outs, target: float) -> torch.Tensor:
    return sum(torch.mean((f[-1] - target) ** 2) for f in outs) / len(outs)


def feature_matching(real_outs, fake_outs, lambda_feat: float):
    loss = 0.0
    for rf, ff in zip(real_outs, fake_outs):
        w = 4.0 / len(rf) / len(real_outs)
        for r, f in zip(rf[:-1], ff[:-1]):
            loss = loss + w * torch.mean(torch.abs(f - r))
    return lambda_feat * loss


def vgg_loss(vgg, fake, real):
    f_feats = vgg(fake)
    with torch.no_grad():
        r_feats = vgg(real)
    return sum(w * torch.mean(torch.abs(f - r))
               for w, f, r in zip(nets.VGG_WEIGHTS, f_feats, r_feats))


def uv_loss(uv, dp_uv, dp_parts):
    B, P, _, H, W = uv.shape
    idx = (dp_parts - 1).clamp(min=0)
    pred = torch.gather(uv, 1, idx[:, None, None].expand(B, 1, 2, H, W))[:, 0]
    fg = (dp_parts > 0).float()[:, None]
    return (torch.abs(pred - dp_uv) * fg).sum() / torch.clamp(
        fg.sum() * 2.0, min=1.0)


def part_ce(logits, dp_parts):
    logp = torch.log_softmax(logits, dim=1)
    return -torch.gather(logp, 1, dp_parts[:, None])[:, 0].mean()


def temporal_loss(cur, prev, flow, flow_inv):
    warped = flow_warp(torch.cat([prev, flow_inv], dim=1), flow)
    warped_prev, warped_inv = warped[:, :3], warped[:, 3:]
    diff2 = torch.sum((flow + warped_inv) ** 2, dim=1, keepdim=True)
    mag2 = torch.sum(flow ** 2 + warped_inv ** 2, dim=1, keepdim=True)
    mask = (diff2 < 0.01 * mag2 + 0.5).float()
    err = torch.abs(cur - warped_prev)
    return (err * mask).sum() / torch.clamp(mask.sum() * 3.0, min=1.0)


def train_losses(cfg, G, D, vgg, static_tex, bg, b):
    """Both forwards and both backwards of one step on a dequantised
    batch `b` -> (G's losses, G's total, D's total); the gradients are
    left on the parameters."""
    pose = pose_input(cfg, b["joints"])
    real = b["image"]
    tex, bg = static_tex[None], bg[None]
    temporal = cfg.lambda_Temp > 0
    real_prev = temporal and cfg.temporal_prev == "real"
    prev_fake = None
    if temporal and not real_prev:
        with torch.no_grad():
            prev_fake = G(pose_input(cfg, b["joints_prev"]), bg, tex,
                          feat_image=b.get("image_prev", real))["fake"]
    elif real_prev:
        prev_fake = b["image_prev"]
    for p in (*G.parameters(), *D.parameters()):
        p.grad = None
    D.requires_grad_(False)
    cur = G(pose, bg, tex, feat_image=real)
    fake = cur["fake"]
    d_fake = D(torch.cat([pose, fake], dim=1))
    losses = {"G_GAN": _mse_to(d_fake, 1.0)}
    if not cfg.no_ganFeat_loss:
        with torch.no_grad():
            d_real = D(torch.cat([pose, real], dim=1))
        losses["G_FM"] = feature_matching(d_real, d_fake, cfg.lambda_feat)
    if not cfg.no_vgg_loss:
        losses["G_VGG"] = cfg.lambda_feat * vgg_loss(vgg, fake, real)
    if cfg.lambda_L2 > 0:
        losses["G_L2"] = cfg.lambda_L2 * torch.mean((fake - real) ** 2)
    if cfg.use_densepose_loss:
        losses["G_UV"] = cfg.lambda_UV * uv_loss(cur["uv"], b["dp_uv"],
                                                 b["dp_parts"])
        losses["G_Prob"] = cfg.lambda_Prob * part_ce(cur["logits"],
                                                     b["dp_parts"])
    if cfg.lambda_Mask > 0 and "mask" in b:
        losses["G_Mask"] = cfg.lambda_Mask * torch.mean(
            torch.abs(cur["mask"] - b["mask"]))
    if temporal:
        losses["G_Temp"] = cfg.lambda_Temp * temporal_loss(
            fake, prev_fake, b["flow"], b["flow_inv"])
    g_total = functools.reduce(torch.add, losses.values())
    g_total.backward()
    D.requires_grad_(True)
    d_real = D(torch.cat([pose, real], dim=1))
    d_fake = D(torch.cat([pose, fake.detach()], dim=1))
    d_total = 0.5 * (_mse_to(d_real, 1.0) + _mse_to(d_fake, 0.0))
    d_total.backward()
    return losses, g_total, d_total


class Adam:
    """Adam with eps added to the bias-corrected sqrt(v)."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = \
            params, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / bc1) / (v.sqrt() / bc2 ** 0.5 + self.eps))


class Trainer:
    """The reference's own training state over the networks of
    ``nets.build`` (with their weights loaded) and the assets."""

    def __init__(self, cfg, G, D, vgg, static_tex, bg):
        self.cfg, self.G, self.D, self.vgg = cfg, G, D, vgg
        self.static_tex, self.bg = static_tex, bg
        self.g_names = [n for n, _ in G.named_parameters()]
        self.d_names = [n for n, _ in D.named_parameters()]
        self.g_opt = Adam([p for _, p in G.named_parameters()], cfg.lr,
                          cfg.beta1, cfg.beta2)
        self.d_opt = Adam([p for _, p in D.named_parameters()], cfg.lr,
                          cfg.beta1, cfg.beta2)
        self.ema = ({n: p.detach().clone() for n, p in G.named_parameters()}
                    if cfg.ema_decay > 0 else None)
        self.count = 0
        if vgg is not None:
            vgg.requires_grad_(False)

    def step(self, host_batch) -> Dict[str, float]:
        b = dequantize(host_batch, self.static_tex.device)
        losses, g_total, d_total = train_losses(
            self.cfg, self.G, self.D, self.vgg, self.static_tex, self.bg, b)
        self.g_opt.step()
        self.d_opt.step()
        if self.ema is not None:
            t = self.count + 1
            d = min(self.cfg.ema_decay, (1.0 + t) / (10.0 + t))
            with torch.no_grad():
                for n, p in self.G.named_parameters():
                    self.ema[n].mul_(d).add_(p, alpha=1.0 - d)
        self.count += 1
        out = {k: float(v.detach()) for k, v in losses.items()}
        out["G_total"], out["D_total"] = float(g_total), float(d_total)
        return out

    def grads(self) -> Dict[str, torch.Tensor]:
        """The gradients the last step's optimizers took, by leaf name
        (G's under "G.", D's under "D.")."""
        out = {f"G.{n}": p.grad for n, p in self.G.named_parameters()}
        out.update({f"D.{n}": p.grad for n, p in self.D.named_parameters()})
        return out


@torch.no_grad()
def render(cfg, G, static_tex, bg, joints: torch.Tensor) -> torch.Tensor:
    """joints (B, 18, 3) -> uint8 NHWC frames."""
    return quantize(G(pose_input(cfg, joints), bg[None],
                      static_tex[None])["fake"])
