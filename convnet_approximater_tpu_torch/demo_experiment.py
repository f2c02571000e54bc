"""The end-to-end experiment protocol in miniature (port of
``scripts/demo_experiment.py``): train a baseline, compress it, recover it,
evaluate every stage, and print the reference's experiment table
(``doc/low-rank-exp/low-rank-exp.md:39-49``).

    python -m convnet_approximater_tpu_torch.demo_experiment [--app v1] [--int8]
        [--int8-qat] [--mixup] [--kd] [--device cuda] ...

1. train a baseline from scratch (``TrainHelper``)          -> row 1 (original)
2. approximate it, undecomposed (``--app v1``: scheme-1 SVD bases)  -> row 2
3. rows 3-5: + L2 fine-tune / + L2 -> CE / + CE only
4. spatially decomposed (separable strips)                 -> row 6
5. rows 7-9: + L2 / + L2 -> CE / + CE only

``--app v3|v4|prune|mlpprune|attnprune`` run rows 2-5 with that app (the
pruning apps through a ``CalibrationHook``), ``trunkprune``/``quadprune`` the
structure passes with a CE row; ``--int8`` adds the baseline under int8 PTQ,
``--int8-qat`` the baseline after QAT and ``convert_qat_to_int8``.  Every
stage runs through the port's public pieces (``TrainHelper``, the Runner,
``L2Reconstruct``, ``ValidateHelper``), on ``Synthetic`` data unless
``--dataset``/``--data-root`` name one.  ``--device`` defaults to ``cuda`` and
fails when no CUDA device is present; ``--platform`` is accepted as its alias
(``cpu``, or ``gpu``/``cuda`` for the card).
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import torch

APPS = ("v1", "v3", "v4", "prune", "mlpprune", "attnprune", "trunkprune", "quadprune")
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="End-to-end experiment protocol (PyTorch port)")
    ap.add_argument("--model", default="AlexNet")
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--model-args", default=None,
                    help="JSON dict of extra model-config kwargs, e.g. "
                         "'{\"num_channels\": [64, 128, 320, 512]}' for MSCAN-S widths")
    ap.add_argument("--image-size", type=int, nargs=2, default=(64, 64))
    ap.add_argument("--num-bases", type=int, nargs="+", default=[8, 8, 6, 4])
    ap.add_argument("--indices", type=int, nargs="+", default=[2, 3, 4, 5])
    ap.add_argument("--train-epochs", type=int, default=30)
    ap.add_argument("--ft-epochs", type=int, default=5,
                    help="L2-reconstruction epochs (reference protocol: 20)")
    ap.add_argument("--ce-epochs", type=int, default=3,
                    help="cross-entropy epochs (reference protocol: 10)")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--app", default="v1", choices=APPS,
                    help="v1: scheme-1 (9 rows); v3: channel-rank factorization (5 rows); "
                         "v4: Tucker-2 (each --num-bases n becomes ranks (n, n)); prune: "
                         "FfnPrune (--model MSCAN_Classifier); mlpprune: the ConvNeXt-block "
                         "variant (--model ConvNeXt); attnprune: the gated MSCA branch "
                         "(--model MSCAN_Classifier); trunkprune: prune_trunks + prune_chains "
                         "(--model ResNet18/50); quadprune: deploy.prune_width "
                         "(--model MSCAN_Classifier)")
    ap.add_argument("--keep-ratio", type=float, default=0.75,
                    help="width keep ratio of every pruning app")
    ap.add_argument("--int8", action="store_true",
                    help="also evaluate the trained original under int8 PTQ (fold -> "
                         "calibrate on real batches -> quantize)")
    ap.add_argument("--int8-qat", action="store_true",
                    help="also fine-tune the trained original under fake-quant (fold -> "
                         "prepare_qat -> CE fine-tune -> convert to int8)")
    ap.add_argument("--qat-epochs", type=int, default=3, help="QAT fine-tune epochs (--int8-qat)")
    ap.add_argument("--mixup", action="store_true",
                    help="train the baseline with Mixup(0.8) + CutMix(1.0) and global-norm "
                         "gradient clipping 1.0")
    ap.add_argument("--kd", action="store_true",
                    help="add logit distillation (kd_weight=0.5, T=4) to the L2 rows")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device: cuda (the default), cuda:N or cpu")
    ap.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                    help="the JAX CLI's flag, as an alias of --device")
    ap.add_argument("--work-dir", default="work_dirs/demo_experiment")
    args = ap.parse_args(argv)
    if args.platform:
        platform = PLATFORMS[args.platform]
        if args.device is not None and torch.device(args.device).type != platform:
            ap.error(f"--platform {args.platform} and --device {args.device} disagree")
        args.device = args.device or platform
    args.device = args.device or "cuda"
    return args


def app_config(args, decomp: bool) -> str:
    """The ``app`` line of a pipeline row's config."""
    if args.app in ("trunkprune", "quadprune"):
        # cross-layer cuts are structure passes, not per-module apps
        return "dict(type='Dummy')"
    if args.app in ("prune", "mlpprune", "attnprune"):
        app_type = {"prune": "FfnPrune", "mlpprune": "MlpPrune", "attnprune": "AttnPrune"}[args.app]
        return f"dict(type='{app_type}', keep_ratio={args.keep_ratio})"
    if args.app == "v3":
        return f"dict(type='LowRankExpV3', num_bases={tuple(args.num_bases)})"
    if args.app == "v4":
        return f"dict(type='LowRankExpV4', num_bases={tuple((n, n) for n in args.num_bases)})"
    return (f"dict(type='LowRankExpV1', max_iter=0, min_lmda=0, max_lmda=0, "
            f"init_method='svd', lmda_length=1, num_bases={tuple(args.num_bases)}, "
            f"do_decomp={decomp})")


def site_config(args, hooks_py: str, ds_cfg: dict, size):
    """``(filters, structure passes, hooks)`` lines of a pipeline row's config."""
    passes_py = ""
    if args.app == "trunkprune":
        filters_py = "[]"
        passes_py = ("structure_passes = ["
                     f"dict(fn='prune_trunks', keep_ratio={args.keep_ratio}, round_to=None), "
                     f"dict(fn='prune_chains', keep_ratio={args.keep_ratio}, round_to=None)]\n")
    elif args.app == "quadprune":
        filters_py = "[]"
        passes_py = ("structure_passes = ["
                     f"dict(fn='prune_width', keep_ratio={args.keep_ratio}, "
                     "round_to=None, ffn_round_to=None)]\n")
    elif args.app in ("prune", "mlpprune", "attnprune"):
        # the prune apps key on module type and select channels from data
        filters_py = "[]"
        cal = ("dict(type='CalibrationHook', priority=40, num_batches=2, "
               f"batch_size={args.batch_size}, image_size={size}, dataset={ds_cfg!r})")
        hooks_py = f"[{cal}]" if hooks_py == "[]" else f"[{cal}, " + hooks_py[1:]
    elif args.model.startswith("ResNet"):
        # ResNet's block convs have no bias, which SimpleConvFilter rejects
        filters_py = ("[dict(type='KernelSizeFilter', min_kernel=2, max_kernel=5), "
                      f"dict(type='IndicesFilter', indices={tuple(args.indices)})]")
    else:
        filters_py = ("[dict(type='SimpleConvFilter'), "
                      f"dict(type='IndicesFilter', indices={tuple(args.indices)})]")
    return filters_py, passes_py, hooks_py


def main(argv=None) -> list:
    """Run the protocol; the table's rows (tag, top1, MACs and params in millions)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")

    from convnet_approximater_tpu_torch import deploy
    from convnet_approximater_tpu_torch.classification import TrainHelper, ValidateHelper
    from convnet_approximater_tpu_torch.data import Loader, build_dataset
    from convnet_approximater_tpu_torch.hooks.model_analysis import count_macs, count_params
    from convnet_approximater_tpu_torch.models import build_model
    from convnet_approximater_tpu_torch.nn import init_weights
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import build_logger, init_cfg, update_cfg

    build_logger()
    os.makedirs(args.work_dir, exist_ok=True)
    size = tuple(args.image_size)
    ds_cfg = (dict(type=args.dataset, root=args.data_root) if args.dataset
              else dict(type="Synthetic", num_samples=args.samples, image_size=size + (3,),
                        num_classes=args.num_classes, signal=0.8))
    # the Synthetic classes carry a signal shared across splits, so a held-out
    # evaluation means something without external data
    eval_split = "validation"

    def evaluate(model, tag):
        res = ValidateHelper(model, dict(batch_size=args.batch_size, input_size=size + (3,),
                                         num_classes=args.num_classes, dataset=ds_cfg,
                                         split=eval_split, log_freq=10**9),
                             device=device).validate()
        with torch.no_grad():
            macs = count_macs(model.eval(), torch.zeros((1, 3) + size, device=device))
        return dict(tag=tag, top1=res["top1"], macs=macs / 1e6, params=count_params(model) / 1e6)

    rows = []

    # -- 1. the baseline ---------------------------------------------------
    extra_model = json.loads(args.model_args) if args.model_args else {}
    model = build_model(dict(type=args.model, num_classes=args.num_classes, **extra_model))
    init_weights(model, torch.Generator().manual_seed(0))
    aug_cfg = dict(mixup=0.8, cutmix=1.0, clip_grad=1.0) if args.mixup else {}
    TrainHelper(model, dict(
        dataset=ds_cfg, num_classes=args.num_classes, epochs=args.train_epochs,
        batch_size=args.batch_size, lr=1e-3, image_size=size,
        work_dir=os.path.join(args.work_dir, "baseline"), log_interval=10**9, **aug_cfg,
    ), device=device).train()
    base_ckpt = os.path.join(args.work_dir, "baseline", "model_best.ckpt.npz")
    rows.append(evaluate(model, "original"))

    if args.int8:
        qm = copy.deepcopy(model)
        deploy.fold_batchnorm(qm)
        loader = Loader(build_dataset(dict(ds_cfg), split=eval_split), args.batch_size,
                        image_size=size, device=device)
        calib = []
        for xb, _ in loader:
            calib.append(xb)
            if len(calib) >= 4:
                break
        nq = deploy.quantize_int8(qm, calib)
        rows.append(evaluate(qm, f"original int8 ({nq} mod)"))

    if args.int8_qat:
        qm = copy.deepcopy(model)
        deploy.fold_batchnorm(qm)
        nq = deploy.prepare_qat(qm)
        TrainHelper(qm, dict(
            dataset=ds_cfg, num_classes=args.num_classes, epochs=args.qat_epochs,
            batch_size=args.batch_size, lr=1e-4, image_size=size,
            work_dir=os.path.join(args.work_dir, "qat"), log_interval=10**9,
        ), device=device).train()
        deploy.convert_qat_to_int8(qm)
        rows.append(evaluate(qm, f"original int8 QAT ({nq} mod)"))

    # -- rows 2-9: pipeline configs ----------------------------------------
    def pipeline(hooks_py, tag, decomp):
        filters_py, passes_py, hooks_py = site_config(args, hooks_py, ds_cfg, size)
        cfg = os.path.join(args.work_dir, f"cfg_{tag}.py")
        with open(cfg, "w") as f:
            f.write(f"""
model = dict(type="{args.model}", num_classes={args.num_classes},
             init_cfg=r"{base_ckpt}", **{extra_model!r})
app = {app_config(args, decomp)}
filters = {filters_py}
{passes_py}hooks = {hooks_py}
""")
        init_cfg(cfg)
        update_cfg(work_dir=os.path.join(args.work_dir, tag), config_name=tag, seed=0)
        runner = Runner(device=device, generator=torch.Generator().manual_seed(0))
        runner.run()
        rows.append(evaluate(runner.model, tag))

    def ft_common(epochs):
        return f"""
        dataset_args=dict(dataset={ds_cfg!r}, batch_size={args.batch_size}),
        data_config=dict(image_size={size}),
        optim_args=dict(opt="adamw", lr=1e-4, weight_decay=0.01),
        sche_args=dict(epochs={epochs}),
        other_args=dict(num_classes={args.num_classes}, log_interval=10**9),
"""
    # the L2 phase trains only the substituted layers (the default freeze), the
    # CE phase everything (no_norm unfreezes)
    kd_py = "kd_weight=0.5, kd_temperature=4.0, " if args.kd else ""
    l2_hook = ("dict(type='L2Reconstruct', priority=50, asym=True, "
               "l2_weight=1.0, cls_weight=0.0, " + kd_py + ft_common(args.ft_epochs) + ")")
    ce_hook = ("dict(type='L2Reconstruct', priority=50, asym=True, no_norm=True, "
               "l2_weight=0.0, cls_weight=1.0," + ft_common(args.ce_epochs) + ")")
    # the reference's rows: 2-5 undecomposed, 6-9 spatially decomposed (only V1
    # has a separate decomposed form)
    variants = ((False, "approx"), (True, "decomp")) if args.app == "v1" else ((False, args.app),)
    for decomp, prefix in variants:
        pipeline("[]", f"{prefix}_none", decomp)
        if args.app in ("trunkprune", "quadprune"):
            # structure passes leave no Substitution to reconstruct against
            pipeline(f"[{ce_hook}]", f"{prefix}_ce", decomp)
            continue
        pipeline(f"[{l2_hook}]", f"{prefix}_l2", decomp)
        pipeline(f"[{l2_hook}, {ce_hook}]", f"{prefix}_l2ce", decomp)
        pipeline(f"[{ce_hook}]", f"{prefix}_ce", decomp)

    # -- the table -----------------------------------------------------------
    print("\n=== experiment table (reference doc/low-rank-exp/low-rank-exp.md:39-49) ===")
    print(f"{'row':>3} | {'config':<14} | {'top-1 %':>8} | {'MACs (M)':>9} | {'params (M)':>10}")
    print("-" * 58)
    for i, r in enumerate(rows):
        print(f"{i + 1:>3} | {r['tag']:<14} | {r['top1']:8.2f} | {r['macs']:9.1f} | "
              f"{r['params']:10.2f}")
    return rows


if __name__ == "__main__":
    main()
