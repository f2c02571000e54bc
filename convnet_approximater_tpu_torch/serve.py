"""Serving loop of the PyTorch port over an exported artifact (the counterpart
of ``scripts/serve.py``): any model family.

    python -m convnet_approximater_tpu_torch.export_model --config <cfg> \\
        [--checkpoint ckpt] --out model.pt2 [--quantize int8] [--symbolic-batch]
    python -m convnet_approximater_tpu_torch.serve --artifact model.pt2 [--batch 64] \\
        [--batches 32] [--min-batch 2] [--max-batch N] [--ship-uint8] [--device cuda]

loads what ``export_model`` wrote (``deploy.load_serving``), takes the batch,
the image size and the type from the artifact's input contract (a note says
when it overrides a flag), and serves ``Synthetic`` images through
``chunk_batch(pad_batch(forward, --min-batch), --max-batch)``, where the
forward is one ``deploy.compile_serving`` CUDA graph per batch size.  The
batches come through the port's ``Loader``: by default the host normalizes
each batch to float32 in the prefetch thread and ships it pinned; with
``--ship-uint8`` the uint8 batch ships and the card normalizes it with the
mean and std of ``<artifact>.meta.json``.  Copies are ``non_blocking`` and the
loop never waits on the card: one readback at the end.  It prints the JAX
CLI's line ``served N images in S s = R img/s end-to-end (...)``.

The artifact carries its weights, so ``--params`` is refused (the JAX
artifact takes them as an argument), and ``--data-parallel`` waits for a
multi-GPU host (ROADMAP.md queue 1, item 12).  ``--device`` defaults to
``cuda`` and fails when no CUDA device is present; the CPU runs only when
asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from convnet_approximater_tpu_torch import deploy
from convnet_approximater_tpu_torch.data import Loader, Synthetic
from convnet_approximater_tpu_torch.data.datasets import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD

PARAMS_REFUSED = ("--params: the port's artifact carries its weights (torch.export saves them "
                  "with the program); the JAX artifact takes them as an argument")
DATA_PARALLEL_TODO = ("--data-parallel: serving over several cards waits for a multi-GPU host "
                      "(ROADMAP.md queue 1, item 12)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="serving loop over an exported artifact "
                                             "(PyTorch port)")
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--params", default=None, help="refused: the artifact carries its weights")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--min-batch", type=int, default=2,
                    help="pad smaller requests up (deploy.pad_batch)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="run larger requests as sequential chunks of this size "
                         "(deploy.chunk_batch)")
    ap.add_argument("--ship-uint8", action="store_true",
                    help="ship raw uint8 batches and normalize on the card (4x fewer bytes)")
    ap.add_argument("--data-parallel", action="store_true", help="refused: one card only")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    return ap.parse_args(argv)


class HostNormLoader(Loader):
    """The ``Loader`` with the normalization moved to the host: the prefetch
    thread ships float32 batches, ``(x - 255 mean) / (255 std)`` in the same
    order, pinned for a ``non_blocking`` copy, cast to the loader's type on the
    card."""

    def _prep(self, idx: np.ndarray):
        images, labels = self.gather(idx)
        x = (images.astype(np.float32) - self.mean) / self.std
        x, labels = torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(labels)
        if self.device.type == "cuda":
            x, labels = x.pin_memory(), labels.pin_memory()
        return x, labels

    def _put(self, batch):
        x, labels = batch
        x = x.to(self.device, non_blocking=True).to(self.dtype)
        return x.permute(0, 3, 1, 2), labels.to(self.device, non_blocking=True)


def graph_per_batch_size(module) -> callable:
    """``module``'s forward, served through one ``compile_serving`` session
    (a CUDA graph on the card) per distinct input shape."""
    sessions = {}

    def forward(x):
        key = tuple(x.shape)
        if key not in sessions:
            sessions[key] = deploy.compile_serving(module, x)[0]
        return sessions[key](x)

    forward.sessions = sessions
    return forward


def read_meta(artifact: str):
    """(mean, std) of ``<artifact>.meta.json``, ImageNet's with a warning
    where it records none."""
    path = artifact + ".meta.json"
    meta = {}
    if os.path.exists(path):
        with open(path) as f:
            meta = json.load(f)
    if "mean" not in meta or "std" not in meta:
        print(f"warning: {path} records no mean/std: assuming ImageNet normalization "
              f"(export with export_model to record the real contract)", flush=True)
    return meta.get("mean", IMAGENET_DEFAULT_MEAN), meta.get("std", IMAGENET_DEFAULT_STD)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.params:
        raise NotImplementedError(PARAMS_REFUSED)
    if args.data_parallel:
        raise NotImplementedError(DATA_PARALLEL_TODO)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    t0 = time.perf_counter()
    module = deploy.load_serving(args.artifact)
    load_s = time.perf_counter() - t0
    x_aval = module.in_avals[-1]
    B, C, H, W = x_aval.shape
    if H is not None and (args.image_size, args.image_size) != (H, W):
        print(f"note: artifact expects {(H, W)} inputs: overriding --image-size "
              f"{args.image_size}", flush=True)
        args.image_size = H
    if B is not None and args.batch != B:
        print(f"note: artifact is batch-static at {B}: overriding --batch {args.batch}",
              flush=True)
        args.batch = B
    dtype = x_aval.dtype  # the artifact's input type, as the JAX server reads it

    graphs = graph_per_batch_size(module)
    # pad inside chunk: a remainder chunk of one row is padded too; a symbolic
    # batch exported on the card starts at 2 (deploy.export_serving)
    min_batch = max(args.min_batch, module.batch_range[0] if module.batch_range else 1)
    fwd = deploy.pad_batch(graphs, min_batch)
    if args.max_batch:
        fwd = deploy.chunk_batch(fwd, args.max_batch)
    mean, std = read_meta(args.artifact)
    size = (args.image_size, args.image_size)
    ds = Synthetic(max(args.batch * 4, 64), size + (C,), 1000)
    loader_type = Loader if args.ship_uint8 else HostNormLoader
    loader = loader_type(ds, args.batch, shuffle=False, drop_last=True, mean=mean, std=std,
                         device=device, dtype=dtype)

    x0 = torch.zeros(args.batch, C, *size, device=device, dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    t0 = time.perf_counter()
    fwd(x0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    print(f"artifact load {load_s:.2f} s; capture + first batch: {first_s:.2f} s", flush=True)

    served, preds, i = 0, None, 0
    t0 = time.perf_counter()
    while i < args.batches:
        for images, _ in loader:
            if i >= args.batches:
                break
            preds = fwd(images)
            served += images.shape[0]
            i += 1
    checksum = float(preds.float().sum())  # the one readback: drains the card
    seconds = time.perf_counter() - t0
    kind = "uint8 shipped, normalized on the card" if args.ship_uint8 else \
        "float32 normalized on the host"
    print(f"served {served} images in {seconds:.3f}s = {served / seconds:.0f} img/s "
          f"end-to-end (batch {args.batch}, {str(dtype).removeprefix('torch.')}, {kind})",
          flush=True)
    return dict(served=served, seconds=seconds, img_per_s=served / seconds, load_s=load_s,
                first_s=first_s, checksum=checksum, batch=args.batch, module=module,
                sessions=len(graphs.sessions))


if __name__ == "__main__":
    main()
