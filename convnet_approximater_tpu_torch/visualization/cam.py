"""Class-activation-map methods (port of ``convnet_approximater_tpu/visualization/cam.py``),
and their CLI.

Each method is a small function of the captured feature map ``feats`` (NCHW,
batch 1) and, for the gradient family, the class score's gradient ``grads``
with respect to it (same shape):

* gradient family: gradcam, gradcam_pp, hirescam, gradcam_elementwise,
  xgradcam, layercam, eigengradcam;
* gradient-free: eigencam (the activations' first principal component),
  scorecam (masked re-forwards), ablationcam (channel-knockout re-forwards);
* fullgrad: the whole model's input and bias gradients.

Each returns an (H, W) non-negative heatmap, not normalised.  ``CAM_METHODS``
maps the CLI's names to the functions and their calling convention.

    python -m convnet_approximater_tpu_torch.visualization.cam --config <cfg>
        [--checkpoint CKPT] [--block N] [--method attn|gradcam|...]
        [--image IMG.npy] [--out DIR] [--device cuda|cpu]

builds the config's model with weights from seed 0 (or the checkpoint), and
writes the chosen MSCA block's heatmap for the image's top class (a random
224^2 image from ``RandomState(0)`` when none is given) as ``.png``, or as
``.npy`` without matplotlib.  ``attn`` is the channel mean of the block's
``channel_mix(sd_convs(conv0(x)))``.  The block's output is captured and
overridden with forward hooks; gradients come from an eval forward under
autograd (the module path), the re-forwards run under ``torch.no_grad()``
(the kernels on the card).  ``--device`` defaults to ``cuda`` and fails when
no CUDA device is present.
"""

from __future__ import annotations

import argparse
import os
from contextlib import contextmanager
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from convnet_approximater_tpu_torch.nn import BatchNorm2d

SCORE_CHUNK = 32  # re-forwards per batch in scorecam and ablationcam


def _wide(t):
    """``t`` in float32, or in float64 where it is (a float64 reference run)."""
    return t if t.dtype == torch.float64 else t.float()


def _combine(feats, weights):
    """relu(sum_c w_c * A_c) for per-channel weights (C,)."""
    return F.relu((feats[0] * weights[:, None, None]).sum(0))


# -- gradient family ----------------------------------------------------------
def gradcam(feats, grads):
    """Selvaraju et al.: channel weights are the spatial mean of the gradients."""
    return _combine(feats, grads[0].mean(dim=(1, 2)))


def gradcam_pp(feats, grads):
    """Grad-CAM++ (Chattopadhay et al.): per-pixel alpha weights
    ``g^2 / (2 g^2 + sum_ab(A) * g^3)``."""
    g = grads[0]
    g2, g3 = g * g, g * g * g
    denom = 2.0 * g2 + feats[0].sum(dim=(1, 2), keepdim=True) * g3
    alpha = torch.where(denom.abs() > 1e-12, g2 / denom, torch.zeros_like(denom))
    return _combine(feats, (alpha * F.relu(g)).sum(dim=(1, 2)))


def hirescam(feats, grads):
    """HiResCAM: the elementwise product summed over channels."""
    return F.relu((grads[0] * feats[0]).sum(0))


def gradcam_elementwise(feats, grads):
    """Grad-CAM-ElementWise: relu of the product before the channel sum."""
    return F.relu(grads[0] * feats[0]).sum(0)


def xgradcam(feats, grads):
    """XGrad-CAM: weights ``sum_ij(g * A) / sum_ij(A)``."""
    a = feats[0]
    return _combine(feats, (grads[0] * a).sum(dim=(1, 2)) / (a.sum(dim=(1, 2)) + 1e-8))


def layercam(feats, grads):
    """LayerCAM: positive gradients gate the activations per pixel."""
    return F.relu((F.relu(grads[0]) * feats[0]).sum(0))


def _eigen_projection(maps):
    """Projection of (C, H, W) maps, centred per channel, onto their first
    principal component: (H, W), its sign as the SVD gives it.  The SVD runs
    on the host in float32, one algorithm whatever the maps' device."""
    c, h, w = maps.shape
    m = maps.reshape(c, h * w).t()
    m = (m - m.mean(dim=0, keepdim=True)).cpu()
    _, _, vt = torch.linalg.svd(m, full_matrices=False)
    return (m @ vt[0]).reshape(h, w)


def _eigen_heat(maps):
    """relu of :func:`_eigen_projection`, its sign chosen so that the pixel of
    largest magnitude is positive.  The JAX package chooses the sign of the
    projection's sum, but a projection of centred maps sums to zero, so its
    choice is rounding noise and two devices can take opposite signs."""
    proj = _eigen_projection(maps)
    flat = proj.flatten()
    proj = proj if float(flat[flat.abs().argmax()]) >= 0 else -proj
    return F.relu(proj).to(maps.device)


def eigencam(feats, grads=None):
    """EigenCAM: the first principal component of the activations."""
    return _eigen_heat(feats[0])


def eigengradcam(feats, grads):
    """EigenGradCAM: the same of the gradient-weighted activations."""
    return _eigen_heat(feats[0] * grads[0])


# -- re-forward family ----------------------------------------------------------
def _minmax(maps):
    """Each map of (C, H, W) scaled to [0, 1]."""
    lo = maps.amin(dim=(1, 2), keepdim=True)
    hi = maps.amax(dim=(1, 2), keepdim=True)
    return (maps - lo) / (hi - lo + 1e-8)


def scorecam(feats, x, class_prob_fn: Callable, chunk: int = SCORE_CHUNK):
    """Score-CAM (Wang et al.): each channel's activation, upsampled to the
    input and scaled to [0, 1], masks the input; the masked forward's class
    probability (``class_prob_fn(x_batch) -> (B,)``, the whole model, in
    batches of ``chunk``) weighs the channel, softmax over the channels."""
    masks = _minmax(F.interpolate(feats, size=x.shape[2:], mode="bilinear",
                                  align_corners=False)[0])
    scores = torch.cat([class_prob_fn(x * masks[i:i + chunk, None])
                        for i in range(0, masks.shape[0], chunk)])
    return _combine(feats, torch.softmax(_wide(scores), dim=0))


def ablationcam(feats, override_score_fn: Callable, chunk: int = SCORE_CHUNK):
    """AblationCAM: weight_c = (S - S_c) / |S|, the fractional drop of the class
    score when channel c of the block output is zeroed.
    ``override_score_fn(y) -> (B,)`` re-runs the model with the block output
    overridden by each map of ``y`` (B, C, H, W), in batches of ``chunk``."""
    c = feats.shape[1]
    base = override_score_fn(feats)[0]
    keep = 1.0 - torch.eye(c, dtype=feats.dtype, device=feats.device)
    scores = torch.cat([override_score_fn(feats * keep[i:i + chunk, :, None, None])
                        for i in range(0, c, chunk)])
    return _combine(feats, (base - scores) / (base.abs() + 1e-8))


# -- full-gradient decomposition --------------------------------------------------
def _bias_of(module: nn.Module):
    """The bias a site adds per channel: a conv's own, or a BatchNorm's
    implicit ``bias - mean * weight / sqrt(var + eps)`` (eval mode); None."""
    if isinstance(module, nn.Conv2d):
        return None if module.bias is None else module.bias.detach()
    return (module.bias - module.running_mean * module.weight
            * torch.rsqrt(module.running_var + module.eps)).detach()


def fullgrad_terms(model: nn.Module, x: torch.Tensor, class_idx: int):
    """``(grad_x f, {path: (grad_z f, bias)})`` of the class score ``f`` of an
    eval forward: the input gradient, and for each ``Conv2d`` with a bias and
    each ``BatchNorm2d`` whose output is a map, the gradient at its output and
    its per-channel bias.  For ReLU-style nets they satisfy FullGrad's
    completeness: ``f(x) = <grad_x f, x> + sum_l <grad_z_l f, broadcast(b_l)>``.
    As in the JAX package, a ``Linear`` is not a site.  The forwards run under
    autograd, so every layer takes its module path."""
    sites: Dict[str, Tuple[Tuple[int, ...], torch.Tensor]] = {}
    taps: Dict[str, torch.Tensor] = {}

    def hook_for(path):
        def hook(module, inputs, y):
            if y.dim() != 4:
                return None
            if path not in sites:  # the discovery forward
                b = _bias_of(module)
                if b is not None:
                    sites[path] = (tuple(y.shape), b)
                return None
            return y + taps[path]
        return hook

    model.eval()
    handles = [m.register_forward_hook(hook_for(p)) for p, m in model.named_modules()
               if isinstance(m, (nn.Conv2d, BatchNorm2d))]
    try:
        with torch.enable_grad():
            model(x)
            for p, (shape, _) in sites.items():
                taps[p] = torch.zeros(shape, device=x.device, requires_grad=True)
            xv = x.detach().clone().requires_grad_(True)
            score = model(xv)[0, class_idx]
            grads = torch.autograd.grad(score, [xv] + [taps[p] for p in sites])
    finally:
        for h in handles:
            h.remove()
    return grads[0], {p: (g, sites[p][1]) for p, g in zip(sites, grads[1:])}


def fullgrad(model: nn.Module, x: torch.Tensor, class_idx: int, include_input: bool = True):
    """FullGrad saliency (Srinivas & Fleuret, NeurIPS 2019): ``psi(grad_x f * x)``
    plus, over the sites of :func:`fullgrad_terms`, ``psi(grad_z f * b)``, where
    ``psi`` takes the absolute value, upsamples each channel to the input,
    scales it to [0, 1] and sums the channels.  An (H, W) heatmap at the
    input's resolution."""
    g_x, terms = fullgrad_terms(model, x, class_idx)
    size = x.shape[2:]

    def psi(maps):  # (1, C, h, w) -> (H, W)
        m = F.interpolate(maps.float().abs(), size=size, mode="bilinear", align_corners=False)
        return _minmax(m[0]).sum(0)

    heat = torch.zeros(size, device=x.device)
    if include_input:
        heat = heat + psi(g_x * x)
    for g, b in terms.values():
        heat = heat + psi(g * b[:, None, None])
    return heat.detach()


# name -> (function, convention): 'grad' takes (feats, grads), 'feat' (feats),
# 'score' and 'override' re-run the model, 'model' takes (model, x, class)
CAM_METHODS = {
    "gradcam": (gradcam, "grad"),
    "gradcam++": (gradcam_pp, "grad"),
    "hirescam": (hirescam, "grad"),
    "gradcam-elementwise": (gradcam_elementwise, "grad"),
    "xgradcam": (xgradcam, "grad"),
    "layercam": (layercam, "grad"),
    "eigengradcam": (eigengradcam, "grad"),
    "eigencam": (eigencam, "feat"),
    "scorecam": (scorecam, "score"),
    "ablationcam": (ablationcam, "override"),
    "fullgrad": (fullgrad, "model"),
}


# -- the CLI ----------------------------------------------------------------------
@contextmanager
def block_capture(block: nn.Module, captured: dict):
    """Keep ``block``'s input and output of each forward in ``captured``."""
    def hook(module, inputs, y):
        captured["in"], captured["out"] = inputs[0], y

    handle = block.register_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()


@contextmanager
def block_override(block: nn.Module, y_override: torch.Tensor):
    """Replace ``block``'s output by ``y_override`` in each forward."""
    handle = block.register_forward_hook(lambda module, inputs, y: y_override)
    try:
        yield
    finally:
        handle.remove()


def attn_map(msca: nn.Module, xin: torch.Tensor) -> torch.Tensor:
    """The block's attention map ``channel_mix(sd_convs(conv0(x)))``."""
    return msca.channel_mix(msca.sd_convs(msca.conv0(xin)))


def normalize(m: np.ndarray) -> np.ndarray:
    m = m - m.min()
    return m / (m.max() + 1e-8)


def heatmap(model: nn.Module, x: torch.Tensor, block: int, method: str) -> np.ndarray:
    """The un-normalised heatmap of ``method`` (or ``attn``) at MSCA block
    ``block`` of ``model`` (eval mode, MSCA registered) for the top class of
    the image ``x`` (1, 3, H, W)."""
    msca = model.get_switchable_module(block)
    captured: dict = {}
    with torch.no_grad(), block_capture(msca, captured):
        logits = model(x)
    if method == "attn":
        with torch.no_grad():
            return attn_map(msca, captured["in"])[0].mean(0).cpu().numpy()
    cls = int(logits[0].argmax())
    feats = captured["out"].detach()
    fn, kind = CAM_METHODS[method]

    def scores(xb, y):
        with torch.no_grad(), block_override(msca, y):
            return _wide(model(xb.contiguous(memory_format=torch.channels_last))[:, cls])

    if kind == "model":
        heat = fn(model, x, cls)
    elif kind == "grad":
        y = feats.clone().requires_grad_(True)
        with torch.enable_grad(), block_override(msca, y):
            (grads,) = torch.autograd.grad(model(x)[0, cls], y)
        heat = fn(feats, grads)
    elif kind == "feat":
        heat = fn(feats)
    elif kind == "override":
        heat = fn(feats, lambda y: scores(x.expand(y.shape[0], -1, -1, -1), y))
    else:  # scorecam: masked re-forwards of the whole model
        def class_prob(xb):
            with torch.no_grad():
                out = model(xb.contiguous(memory_format=torch.channels_last))
            return torch.softmax(_wide(out), dim=-1)[:, cls]

        heat = fn(feats, x, class_prob)
    return heat.detach().cpu().numpy()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="CAM of an MSCA block (PyTorch port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None, help="flat .npz of either package")
    ap.add_argument("--block", type=int, default=0, help="MSCA block index")
    ap.add_argument("--method", "--mode", dest="method", default="attn",
                    choices=("attn",) + tuple(CAM_METHODS))
    ap.add_argument("--image", default=None, help="npy image (H, W, 3) uint8; random if omitted")
    ap.add_argument("--out", default="work_dirs/cam")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> np.ndarray:
    """Run the CLI; returns the normalised heatmap it wrote."""
    from convnet_approximater_tpu_torch.convert import load_jax_flat
    from convnet_approximater_tpu_torch.layers import MSCA
    from convnet_approximater_tpu_torch.models import build_model
    from convnet_approximater_tpu_torch.nn import channels_last, init_weights
    from convnet_approximater_tpu_torch.utils import get_cfg, init_cfg, load_flat

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    init_cfg(args.config)
    model = build_model(get_cfg().model)
    init_weights(model, torch.Generator().manual_seed(0))
    if args.checkpoint:
        load_jax_flat(model, load_flat(args.checkpoint))
    channels_last(model.to(device)).eval()
    model.register_switchable(MSCA, [])

    if args.image:
        img = np.load(args.image).astype(np.float32)
    else:
        img = np.random.RandomState(0).randint(0, 256, (224, 224, 3)).astype(np.float32)
    x = torch.from_numpy((img / 255.0 - 0.5) / 0.5).permute(2, 0, 1)[None].to(device)
    x = x.contiguous(memory_format=torch.channels_last)

    heat = normalize(heatmap(model, x, args.block, args.method))
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, f"cam_{args.method}_block{args.block}.png")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(6, 3))
        axes[0].imshow(img.astype(np.uint8))
        axes[0].axis("off")
        axes[1].imshow(heat, cmap="jet")
        axes[1].axis("off")
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
        print(f"wrote {out_path}")
    except ImportError:
        out_path = out_path.replace(".png", ".npy")
        np.save(out_path, heat)
        print(f"matplotlib unavailable; wrote {out_path}")
    return heat


if __name__ == "__main__":
    main()
