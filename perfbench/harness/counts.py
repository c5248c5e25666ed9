"""The yardstick's arithmetic: the card's peaks, the texture-warp kernels'
bytes and operations from their shapes, and the model's operations from
the reference.

Peaks are the NVIDIA H100 SXM data sheet's dense rates. A kernel's
bound is the larger of its bytes at the memory rate and its operations
at the float32 rate (the warp kernels compute in float32 outside the
tensor cores); the step's share of peak counts its convolution and
matrix operations against the bfloat16 tensor-core rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def warp_fwd_bound_s(B: int, P: int, C: int, T: int, N: int, k: int,
                     keep_w: bool, tex_batch: int) -> float:
    """One fused top-k forward: the probabilities read densely (and w
    written where kept for the backward), u and v of the k selected parts
    of each pixel, the atlas, the output; the selection's and the blend's
    operations."""
    nnz = B * N * k
    nbytes = (B * P * N * 4 * (2 if keep_w else 1) + nnz * 8
              + tex_batch * P * C * T * T * 4 + B * C * N * 4)
    return bound_s(nbytes, B * N * P * (2 * k + 2) + nnz * C * 14)


def warp_bwd_bound_s(B: int, P: int, C: int, T: int, N: int, k: int,
                     tex_batch: int) -> float:
    """One backward: w read densely, u and v of the selected pairs, the
    cotangent, the texture read and its gradient written once, du, dv and
    dw written densely."""
    nnz = B * N * k
    tex = tex_batch * P * C * T * T
    nbytes = (B * P * N * 4 + nnz * 8 + B * C * N * 4 + 2 * tex * 4
              + 3 * B * P * N * 4)
    return bound_s(nbytes, nnz * C * 40)


def warp_calls(cfg, kind: str, B: int):
    """The fused forwards (keep_w, batch) and backwards (batch) that one
    step or one rendered batch of B runs."""
    if kind == "train":
        fwd = [(True, B)]
        if cfg.lambda_Temp > 0 and cfg.temporal_prev == "fake":
            fwd.append((False, B))
        return fwd, [B]
    return [(False, B)], []


def warp_bounds(cfg, kind: str, B: int):
    """(forward, backward) bound seconds of one step or batch. The
    texture has a batch axis: TexG's residual is per sample."""
    fwd, bwd = warp_calls(cfg, kind, B)
    P, T, N, k = cfg.n_parts, cfg.tex_tile, cfg.size * cfg.size, cfg.warp_topk
    f = sum(warp_fwd_bound_s(b, P, 3, T, N, k, keep, b) for keep, b in fwd)
    g = sum(warp_bwd_bound_s(b, P, 3, T, N, k, b) for b in bwd)
    return f, g


def model_flops(cfg, kind: str, B: int) -> float:
    """Convolution and matrix operations of one train step (forward and
    backward of G, D and VGG; under the feature flags G's encoder E and
    the pooling's products with it) or of one rendered batch, counted by
    ``FlopCounterMode`` over the reference on the meta device."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import nets, step as ref
    from ..reference.pose import pose_input

    dev = torch.device("meta")
    with torch.device(dev):
        G, D = nets.Renderer(cfg), nets.Discriminator(cfg)
        vgg = None if cfg.no_vgg_loss else nets.VGG19()
    S = cfg.size
    tex = torch.zeros((cfg.n_parts, 3, cfg.tex_tile, cfg.tex_tile),
                      device=dev)
    bg = torch.zeros((3, S, S), device=dev)
    counter = FlopCounterMode(display=False)
    with counter:
        if kind == "train":
            z = {k: torch.zeros((B, c, S, S), device=dev) for k, c in (
                ("image", 3), ("image_prev", 3), ("mask", 1), ("dp_uv", 2),
                ("flow", 2), ("flow_inv", 2))}
            z["dp_parts"] = torch.zeros((B, S, S), dtype=torch.long,
                                        device=dev)
            z["joints"] = z["joints_prev"] = torch.zeros((B, 18, 3),
                                                         device=dev)
            ref.train_losses(cfg, G, D, vgg, tex, bg, z)
        else:
            with torch.no_grad():
                G(pose_input(cfg, torch.zeros((B, 18, 3), device=dev)),
                  bg[None], tex[None])
    return float(counter.get_total_flops())
