"""Serving export CLI of the PyTorch port (the counterpart of
``scripts/export_model.py``): a config and a checkpoint to a ``torch.export``
artifact.

    python -m convnet_approximater_tpu_torch.export_model --config <cfg> \\
        [--checkpoint ckpt] --out model.pt2 [--batch 64] [--input-size 224 224 3] \\
        [--never-lose] [--no-fold-bn] [--quantize int8|int8-qat] [--symbolic-batch] \\
        [--device cuda]

builds the config's model in deploy mode (the app's sites as their bare
targets, the config's ``structure_passes`` first, each site initialized from
the seed), loads the checkpoint (the Runner's ``.pt`` or a flat ``.npz``;
without one it warns and exports random weights), then applies the serving
rewrites in the JAX CLI's order: ``never_lose_deploy``, the BN fold, and
``quantize_int8`` on synthetic calibration batches (``--quantize int8``) or,
for a QAT fine-tune's checkpoint (``--quantize int8-qat``), the replay of
``prepare_qat`` before the strict load and ``convert_qat_to_int8`` after it.
It exports the eval forward with ``deploy.export_serving``, loads the artifact
back and holds its output against the live forward (max-abs below 1e-3, as the
JAX CLI does; the error is logged), and writes ``<out>`` (the program),
``<out>.params.npz`` (the served weights in the flat npz that both packages
read) and ``<out>.meta.json`` (the JAX CLI's preprocessing keys, plus the
input's shape and layout).  The artifact takes NCHW float32 batches that are
``channels_last`` in memory.

The port serves float32 (``--dtype`` other than float32 waits for ROADMAP.md
queue 1, item 7).  ``--device`` defaults to ``cuda`` and fails when no CUDA
device is present; the CPU runs only when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch

from convnet_approximater_tpu_torch import deploy
from convnet_approximater_tpu_torch.convert import variables_of
from convnet_approximater_tpu_torch.core import build_app
from convnet_approximater_tpu_torch.filters import build_filter
from convnet_approximater_tpu_torch.models import build_model
from convnet_approximater_tpu_torch.nn import channels_last, init_weights
from convnet_approximater_tpu_torch.runner.runner import read_checkpoint, structure_pass
from convnet_approximater_tpu_torch.utils import build_logger, get_cfg, init_cfg, save_model

ARTIFACT_TOL = 1e-3  # the JAX CLI's gate: max-abs of the artifact against the live forward
DTYPE_TODO = "the port serves float32 only (bf16 end to end is ROADMAP.md queue 1, item 7)"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="serving export (PyTorch port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None,
                    help="omit for a random-init artifact (serving demos only; logged)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtype", default="float32", help="serving type (float32 only)")
    ap.add_argument("--input-size", type=int, nargs=3, default=(224, 224, 3))
    ap.add_argument("--quantize", default=None, choices=["int8", "int8-qat"],
                    help="int8: PTQ on synthetic calibration batches; int8-qat: the "
                         "checkpoint is a QAT fine-tune, whose learned observer scales "
                         "are converted (BN stays live, as trained)")
    ap.add_argument("--qat-no-linears", action="store_true",
                    help="the QAT run used PrepareQAT(linears=False)")
    ap.add_argument("--qat-include-substituted", action="store_true",
                    help="the QAT run used include_substituted=True")
    ap.add_argument("--qat-folded-bn", action="store_true",
                    help="the QAT run folded BN before prepare_qat: replay the fold first")
    ap.add_argument("--never-lose", action="store_true")
    ap.add_argument("--no-fold-bn", action="store_true")
    ap.add_argument("--symbolic-batch", action="store_true",
                    help="export with a symbolic batch dim: one artifact serves any batch size")
    ap.add_argument("--platforms", default=None,
                    help="comma-separated platforms; only the model's own device type")
    ap.add_argument("--norm-mean", type=float, nargs=3, default=(0.485, 0.456, 0.406),
                    help="preprocessing mean recorded in the .meta.json sidecar")
    ap.add_argument("--norm-std", type=float, nargs=3, default=(0.229, 0.224, 0.225))
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--seed", type=int, default=None, help="seed of the random weights")
    return ap.parse_args(argv)


def serving_meta(mean, std, dtype: str, input_shape, **extra) -> dict:
    """The ``<artifact>.meta.json`` sidecar: the JAX CLIs' preprocessing keys
    (``serve --ship-uint8`` normalizes with its mean and std), ``extra``, and
    the input's shape (``None`` for a symbolic batch) and layout."""
    return {"preprocessing": "normalized",
            "note": "inputs are mean/std-normalized float; --ship-uint8 servers must apply "
                    "the recorded mean/std before the artifact",
            "mean": list(mean), "std": list(std), "dtype": dtype, **extra,
            "input_shape": list(input_shape),
            "input_layout": "NCHW, channels_last in memory (an NHWC block)"}


def write_artifact(model, x, out: str, meta: dict, symbolic_batch: bool = False,
                   platforms=None):
    """Export ``model``'s eval forward at ``x`` to ``out``, load it back and
    hold its output against the live forward (max-abs below ARTIFACT_TOL),
    then write ``<out>.params.npz`` (the served weights in the flat npz that
    both packages read) and ``<out>.meta.json`` (``meta``).  Returns (the
    program's bytes, the loaded module, the error)."""
    data = deploy.export_serving(model, (x,), path=out, symbolic_batch=symbolic_batch,
                                 platforms=platforms)
    served = deploy.load_serving(out)
    with torch.no_grad():
        y_live, y_art = model(x), served(x)
    err = float((y_art.float() - y_live.float()).abs().max())
    if not err < ARTIFACT_TOL:
        raise SystemExit(f"the artifact's output differs from the live forward's by {err:.3e} "
                         f"(max-abs; gate {ARTIFACT_TOL})")
    save_model(variables_of(model), out + ".params.npz")
    with open(out + ".meta.json", "w") as f:
        json.dump(meta, f)
    return data, served, err


def build_deploy_model(cfg, device, seed: int):
    """The config's model in deploy mode on ``device``: weights from ``seed``,
    ``init_cfg``, the structure passes, then each site's bare target."""
    model = build_model(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.load_init_cfg()
    model = channels_last(model.to(device)).eval()
    for fn, kwargs in (structure_pass(p) for p in cfg.structure_passes or []):
        fn(model, **kwargs)
    app = build_app(cfg.app, deploy=True)
    model.register_switchable(app.src_type, [build_filter(f) for f in cfg.filters or []])
    gen = torch.Generator().manual_seed(seed)
    for idx in range(model.length_switchable):
        model.set_switchable_module(idx, app.initialize(model.get_switchable_module(idx),
                                                        gen).eval())
    return channels_last(model).eval()


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.dtype != "float32":
        raise NotImplementedError(f"--dtype {args.dtype}: {DTYPE_TODO}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    platforms = tuple(args.platforms.split(",")) if args.platforms else None
    deploy.check_platforms(platforms, device.type)
    logger = build_logger()
    init_cfg(args.config)
    cfg = get_cfg()
    seed = args.seed if args.seed is not None else (cfg.seed or 0)
    model = build_deploy_model(cfg, device, seed)

    qat = args.quantize == "int8-qat"
    if qat:
        if args.never_lose:
            raise SystemExit("--never-lose is a dense-against-decomposed arbiter; it does not "
                             "compose with --quantize int8-qat")
        if not args.checkpoint:
            raise SystemExit("--quantize int8-qat needs a QAT fine-tune checkpoint (its "
                             "observers are learned); use --quantize int8 for random weights")
        if args.qat_folded_bn and not args.no_fold_bn:
            logger.info(f"fold_batchnorm: {deploy.fold_batchnorm(model)} pairs (before "
                        f"prepare_qat, as the QAT run folded)")
        filter_fn = None if args.qat_include_substituted else deploy.qat_substitution_filter(model)
        nq = deploy.prepare_qat(model, filter_fn=filter_fn, linears=not args.qat_no_linears)
        try:  # the replayed structure must match the checkpoint's
            model.load_state_dict(read_checkpoint(args.checkpoint, device), strict=True)
        except RuntimeError as e:
            raise SystemExit(f"{e}\nthe --qat-* replay flags must match the training run: "
                             f"--qat-folded-bn if it folded BN before prepare_qat, "
                             f"--qat-no-linears / --qat-include-substituted to mirror "
                             f"PrepareQAT's settings") from e
    elif args.checkpoint:
        model.load_state_dict(read_checkpoint(args.checkpoint, device))
    else:
        logger.warning("no --checkpoint: exporting RANDOM-INIT weights (a serving demo "
                       "artifact, not a trained model)")
    model = channels_last(model).eval()

    shape = (args.batch,) + tuple(args.input_size)
    if args.never_lose:
        res = deploy.never_lose_deploy(model, shape)
        logger.info(f"never-lose: {res['kept_decomposed']}/{len(res['layers'])} kept decomposed")
    if not args.no_fold_bn and not qat:
        logger.info(f"fold_batchnorm: {deploy.fold_batchnorm(model)} pairs")
    if qat:
        logger.info(f"convert_qat_to_int8: {deploy.convert_qat_to_int8(model)}/{nq} modules "
                    f"(learned observer scales)")
    H, W, C = args.input_size
    gen = torch.Generator().manual_seed(seed)
    if args.quantize == "int8":
        calib = [torch.randn(8, C, H, W, generator=gen).to(device).contiguous(
            memory_format=torch.channels_last) for _ in range(4)]
        logger.info(f"quantize_int8: {deploy.quantize_int8(model, calib)} modules (synthetic "
                    f"calibration: pass real batches through deploy.quantize_int8 for "
                    f"accuracy-grade scales)")

    x = torch.randn(args.batch, C, H, W, generator=gen).to(device).contiguous(
        memory_format=torch.channels_last)
    meta = serving_meta(args.norm_mean, args.norm_std, args.dtype,
                        [None if args.symbolic_batch else args.batch, C, H, W],
                        quantize=args.quantize)
    data, served, err = write_artifact(model, x, args.out, meta,
                                       symbolic_batch=args.symbolic_batch, platforms=platforms)
    logger.info(f"exported {args.out} ({len(data)} bytes, + .params.npz, .meta.json), artifact "
                f"max err {err:.2e} against the live forward, batch {args.batch}, {args.dtype}, "
                f"custom ops per forward {deploy.custom_op_counts(served)}")
    return dict(out=args.out, bytes=len(data), err=err, model=model, artifact=served,
                ops=deploy.custom_op_counts(served))


if __name__ == "__main__":
    main()
