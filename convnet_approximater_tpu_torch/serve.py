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
each batch to float32 in the prefetch thread, through the native batch prep
(``data/native.py``), and ships it pinned; with
``--ship-uint8`` the uint8 batch ships and the card normalizes it with the
mean and std of ``<artifact>.meta.json``.  Copies are ``non_blocking`` and the
loop never waits on the card: one readback at the end.  It prints the JAX
CLI's line ``served N images in S s = R img/s end-to-end (...)``.

``--data-parallel`` serves each batch across the ranks of the process group,
one process per device, as the reference launched ranks
(``torchrun --nproc-per-node=N -m convnet_approximater_tpu_torch.serve
--data-parallel ...``; ``parallel.initialize_distributed`` reads torchrun's
environment, and each rank's ``--device cuda`` is its own card): every rank
loads the artifact (moved to its card), makes and ships only its contiguous
slice of every batch (the ``Loader``'s ``sharding=``) and serves it; the
logits of all the slices are gathered on every rank, and the main process
prints the report, with the world size in it.  A batch that does not split
evenly is padded up to a multiple of the world size by repeating its rows
(``pad_shards``, as ``deploy.pad_batch_to_multiple`` pads a request), and the
pad's logits are dropped.  ``--min-batch`` and ``--max-batch`` stay the
request's: a rank pads its slice up to its share of ``--min-batch`` (at least
the artifact's least batch, so the request's least rises to the world size)
and chunks it at its share of ``--max-batch``.  A batch-static artifact takes
``--data-parallel`` over one process only (export with ``--symbolic-batch``
to serve slices).  Without a process group ``--data-parallel`` serves on one
device, as the JAX CLI does on one device.

The artifact carries its weights, so ``--params`` is refused (the JAX
artifact takes them as an argument).  ``--device`` defaults to ``cuda`` and
fails when no CUDA device is present; the CPU runs only when asked for with
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from convnet_approximater_tpu_torch import deploy
from convnet_approximater_tpu_torch.data import Loader, Synthetic, apply_aug, native
from convnet_approximater_tpu_torch.data.datasets import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from convnet_approximater_tpu_torch.parallel import (DATA_AXIS, batch_sharding,
                                                     initialize_distributed, is_main_process,
                                                     make_mesh)
from convnet_approximater_tpu_torch.parallel.mesh import axis_ranks

PARAMS_REFUSED = ("--params: the port's artifact carries its weights (torch.export saves them "
                  "with the program); the JAX artifact takes them as an argument")


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
    ap.add_argument("--data-parallel", action="store_true",
                    help="serve each batch across the ranks of the process group (torchrun)")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    return ap.parse_args(argv)


class HostNormLoader(Loader):
    """The ``Loader`` with the normalization moved to the host: the prefetch
    thread writes float32 batches, ``(x - 255 mean) / (255 std)``, into pinned
    memory for a ``non_blocking`` copy, cast to the loader's type on the card.
    The native batch prep (``data/native.py::prep_batch``, the JAX ``Loader``'s
    route) computes it as ``x * (1 / std) + (-mean / std)``, within 1e-6 of the
    numpy version that ``native=False`` (or ``rand_aug``) takes."""

    def _prep(self, idx: np.ndarray):
        pool = self.dataset.images
        rows = self.rows(len(idx))
        out_hw, params, augmented = self.geometry(idx, rows)
        mine = idx[rows]
        labels = torch.from_numpy(self.dataset.labels[mine].astype(np.int64))
        buf = self.pinned((len(mine), *out_hw, pool.shape[3]), torch.float32)
        out = None if buf is None else buf.numpy()
        if self.native and augmented is None:
            if params is None:
                x = native.prep_batch(pool, mine, out_hw, self.mean, self.std, out=out)
            else:
                x = native.prep_batch_aug(pool, mine, out_hw, self.mean, self.std, params,
                                          out=out)
        else:
            images = (apply_aug(augmented, params, out_hw) if augmented is not None
                      else self.gather(idx)[0])
            x = (images.astype(np.float32) - self.mean) / self.std
            if out is not None:
                out[...] = x
        if buf is None:
            return torch.from_numpy(x), labels
        return buf, labels.pin_memory()

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


def data_parallel(forward, mesh, batch: int) -> callable:
    """``forward`` of this rank's slice of a ``batch``-row request over the
    mesh's data axis (every rank's slice the same size, the request padded up
    to a multiple of the ranks): every rank returns the logits of the whole
    request (``all_gather``), the pad's dropped."""
    _, count, group, _ = axis_ranks(mesh, DATA_AXIS)

    def wrapped(x):
        y = forward(x).contiguous()
        parts = [torch.empty_like(y) for _ in range(count)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts)[:batch]

    return wrapped


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
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    mesh = None
    if args.data_parallel:
        device = initialize_distributed(device=device)  # torchrun's rank takes its own card
        if dist.is_initialized():
            mesh = make_mesh(model=1)
        else:
            print("note: --data-parallel without a process group: serving on one device",
                  flush=True)
    world = dist.get_world_size() if mesh is not None else 1
    t0 = time.perf_counter()
    module = deploy.load_serving(args.artifact, device=device)
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
    # a symbolic batch exported on the card starts at 2 (deploy.export_serving)
    least = module.batch_range[0] if module.batch_range else 1
    share = lambda n: -(-n // world)  # noqa: E731  (this rank's rows of an n-row request)
    sharding = None
    if mesh is not None:
        if B is not None and world > 1:
            raise ValueError(f"--data-parallel over {world} processes: the artifact is "
                             f"batch-static at {B} and cannot serve a slice of a batch; export "
                             f"it with --symbolic-batch")
        sharding = batch_sharding(mesh)
        if is_main_process():
            print(f"data-parallel serving over {world} processes, each making and serving "
                  f"its {share(args.batch)} rows of a batch (non-dividing batches are padded "
                  f"up)", flush=True)
    # pad inside chunk: a remainder chunk of one row is padded too
    min_rows = max(share(args.min_batch), least)
    fwd = deploy.pad_batch(graphs, min_rows)
    if args.max_batch:
        fwd = deploy.chunk_batch(fwd, share(args.max_batch))
    if mesh is not None:
        fwd = data_parallel(fwd, mesh, args.batch)
    mean, std = read_meta(args.artifact)
    size = (args.image_size, args.image_size)
    ds = Synthetic(max(args.batch * 4, 64), size + (C,), 1000)
    loader_type = Loader if args.ship_uint8 else HostNormLoader
    loader = loader_type(ds, args.batch, shuffle=False, drop_last=True, mean=mean, std=std,
                         device=device, dtype=dtype, sharding=sharding, pad_shards=True)

    x0 = torch.zeros(share(args.batch), C, *size, device=device, dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    t0 = time.perf_counter()
    fwd(x0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    first_s = time.perf_counter() - t0
    if is_main_process():
        print(f"artifact load {load_s:.2f} s; capture + first batch: {first_s:.2f} s",
              flush=True)

    served, preds, i = 0, None, 0
    t0 = time.perf_counter()
    while i < args.batches:
        for images, _ in loader:
            if i >= args.batches:
                break
            preds = fwd(images)
            served += preds.shape[0]
            i += 1
    checksum = float(preds.float().sum())  # the one readback: drains the card
    seconds = time.perf_counter() - t0
    kind = "uint8 shipped, normalized on the card" if args.ship_uint8 else \
        "float32 normalized on the host"
    if mesh is not None:
        kind += f", data-parallel over {world} processes"
    if is_main_process():
        print(f"served {served} images in {seconds:.3f}s = {served / seconds:.0f} img/s "
              f"end-to-end (batch {args.batch}, {str(dtype).removeprefix('torch.')}, {kind})",
              flush=True)
    return dict(served=served, seconds=seconds, img_per_s=served / seconds, load_s=load_s,
                first_s=first_s, checksum=checksum, batch=args.batch, module=module,
                sessions=len(graphs.sessions), logits=preds, world=world,
                min_batch=min_rows * world, rows=share(args.batch))


if __name__ == "__main__":
    main()
