"""End-to-end MSCAN-t serving demo of the PyTorch port (the counterpart of
``scripts/serve_mscan.py``).

    python -m convnet_approximater_tpu_torch.serve_mscan [--batch 128] [--batches 32] \\
        [--dtype bfloat16] [--tiny] [--device cuda]

builds the MSCAN-t serving surface (``MscaRep(decomp=1, fix=True,
decomp_conv0=True)``, then ``FfnRep(fix=True)`` on blocks 1-6 unless
``--tiny``, the BN fold and the 1x1 convs as matmuls; weights from the seed),
casts its parameters to ``--dtype`` after the fold (bfloat16 by default, as
the JAX script's), captures its forward as one ``deploy.compile_serving``
CUDA graph, and drives a steady-state loop: ``Synthetic`` images through the
port's ``Loader`` (a prefetch thread gathers uint8 batches into pinned
memory through the native batch prep, ``data/native.py``, the card
normalizes them after a ``non_blocking`` copy; the session's
input copy casts them to ``--dtype``, as the JAX script casts inside the
served function), the graph replayed per batch, the argmax kept on the card,
one readback at the end.  ``--tiny`` is a narrow MSCAN with at most 8 images
of at most 64² and 4 batches.  ``--device`` defaults to ``cuda`` and fails when no CUDA device is
present; the CPU runs only when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch

from convnet_approximater_tpu_torch import deploy
from convnet_approximater_tpu_torch.core import FfnRep, MscaRep
from convnet_approximater_tpu_torch.data import Loader, Synthetic
from convnet_approximater_tpu_torch.deploy_planner import apply_app
from convnet_approximater_tpu_torch.filters import IndicesFilter
from convnet_approximater_tpu_torch.models import MSCAN_Classifier
from convnet_approximater_tpu_torch.nn import channels_last, init_weights
from convnet_approximater_tpu_torch.utils.dtype import DTYPES, cast_floating

TINY = dict(num_channels=(8, 16, 24, 32), num_blocks=(1, 1, 1, 1), exp_ratios=(2, 2, 2, 2),
            num_classes=16)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="MSCAN-t serving demo (PyTorch port)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--batches", type=int, default=32)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="serving type (bfloat16 by default, as the JAX script's)")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--tiny", action="store_true", help="tiny model and few batches (smoke mode)")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    return ap.parse_args(argv)


def build_surface(tiny: bool, device, seed: int = 0, dtype=torch.float32):
    """MSCAN-t (or the tiny MSCAN) as the serving surface, its parameters cast
    to ``dtype`` after the fold; returns (model, the sites each rewrite found)."""
    model = MSCAN_Classifier(**TINY) if tiny else MSCAN_Classifier(num_classes=1000)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = channels_last(model.to(device)).eval()
    sites = dict(mscarep=apply_app(model, MscaRep(decomp=1, fix=True, decomp_conv0=True), [],
                                   torch.Generator().manual_seed(seed)))
    if not tiny:
        sites["ffnrep"] = apply_app(model, FfnRep(fix=True), [IndicesFilter((1, 2, 3, 4, 5, 6))],
                                    torch.Generator().manual_seed(seed + 1))
    sites["fold"] = deploy.fold_batchnorm(model)
    sites["pw_matmul"] = deploy.enable_pw_matmul(model)
    cast_floating(model, dtype)
    return channels_last(model).eval(), sites


def main(argv=None) -> dict:
    args = parse_args(argv)
    dtype = DTYPES[args.dtype]
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    if args.tiny:
        args.image_size = min(args.image_size, 64)
        args.batch = min(args.batch, 8)
        args.batches = min(args.batches, 4)
    model, sites = build_surface(args.tiny, device, args.seed, dtype)
    print("serving surface: " + ", ".join(f"{k} {v}" for k, v in sites.items()), flush=True)

    size = (args.image_size, args.image_size)
    ds = Synthetic(max(args.batch * 4, 64), size + (3,), 1000)
    loader = Loader(ds, args.batch, shuffle=False, drop_last=True, device=device)
    x0 = torch.zeros(args.batch, 3, *size, device=device, dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    t0 = time.perf_counter()
    compiled, _ = deploy.compile_serving(model, x0)
    compiled().argmax(dim=-1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"capture + first batch: {time.perf_counter() - t0:.2f} s", flush=True)

    served, preds, i = 0, None, 0
    t0 = time.perf_counter()
    while i < args.batches:
        for images, _ in loader:
            if i >= args.batches:
                break
            preds = compiled(images).argmax(dim=-1)  # enqueued; the host preps the next batch
            served += images.shape[0]
            i += 1
    preds = preds.cpu()  # drains the card
    seconds = time.perf_counter() - t0
    print(f"served {served} images in {seconds:.3f}s = {served / seconds:.0f} img/s "
          f"end-to-end (host prep + H2D + forward, batch {args.batch}, {args.dtype})",
          flush=True)
    return dict(served=served, seconds=seconds, img_per_s=served / seconds, batch=args.batch,
                sites=sites, model=model, compiled=compiled, preds=preds)


if __name__ == "__main__":
    main()
