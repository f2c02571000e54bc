"""Serving planner CLI of the PyTorch port (the counterpart of
``scripts/plan_serving.py``).

    python -m convnet_approximater_tpu_torch.plan_serving --config <cfg> \\
        [--checkpoint ckpt] [--batch 64] [--input-size 224 224 3] [--min-agree 0.9] \\
        [--only SUBSTR,...] [--skip SUBSTR,...] [--retime] [--out serving_plan.json] \\
        [--emit-recovery DIR] [--export ARTIFACT] [--device cuda]

builds every candidate serving surface of the config's model
(``deploy_planner.default_candidates``), times them, gates each rewritten one
on its top-1 agreement with the dense float32 model, prints the report and the
winner, and writes the plan to ``--out``.  An existing plan of the same model,
shape and type is replayed (only its winner rebuilt, nothing timed) unless
``--retime``.  ``--emit-recovery`` writes one fine-tune config per lossy stage
of the winner and of every surface below ``--min-agree``, chained through
``model.init_cfg``.  ``--export ARTIFACT`` writes the winning surface as a
``torch.export`` artifact at the planned batch, held against the live
forward and with the ``.params.npz`` and ``.meta.json`` sidecars (the
``--norm-mean``/``--norm-std`` that ``serve --ship-uint8`` applies), as
``export_model`` writes them; ``serve`` serves it.
``--device`` defaults to ``cuda`` and fails when no CUDA device is present;
the CPU runs only when asked for with ``--device cpu``.  The port plans
float32 only.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from convnet_approximater_tpu_torch.deploy_planner import (default_candidates, plan_serving,
                                                           plan_to_json, recovery_plan)
from convnet_approximater_tpu_torch.export_model import serving_meta, write_artifact
from convnet_approximater_tpu_torch.models import build_model
from convnet_approximater_tpu_torch.nn import channels_last, init_weights
from convnet_approximater_tpu_torch.runner.runner import read_checkpoint
from convnet_approximater_tpu_torch.utils import build_logger, get_cfg, init_cfg

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def emit_recovery_configs(args, plan, logger):
    """One fine-tune config per lossy stage (``recovery_plan`` order) of the
    winner and of every surface below ``--min-agree``, each ``_base_``-ing the
    user's config; stage N's ``model.init_cfg`` is left for stage N-1's saved
    checkpoint (stage 1: the trained dense model's).  A quantized surface gets a
    QAT stage (PrepareQAT + CE).  The dataset placeholders are Synthetic:
    replace them with the real training data."""
    os.makedirs(args.emit_recovery, exist_ok=True)
    base = os.path.abspath(args.config)
    size = tuple(args.input_size[:2])
    l2 = ("dict(type='L2Reconstruct', priority=50, asym=True, l2_weight=1.0, "
          "cls_weight=0.0, dataset_args=dict(dataset=DATASET, batch_size=32), "
          f"data_config=dict(image_size={size}), "
          "optim_args=dict(opt='adamw', lr=1e-4, weight_decay=0.01), "
          f"sche_args=dict(epochs={args.recovery_epochs}), "
          "other_args=dict(num_classes=NUM_CLASSES, log_interval=50))")
    ce = ("dict(type='L2Reconstruct', priority=51, asym=True, no_norm=True, "
          "l2_weight=0.0, cls_weight=1.0, "
          "dataset_args=dict(dataset=DATASET, batch_size=32), "
          f"data_config=dict(image_size={size}), "
          "optim_args=dict(opt='adamw', lr=1e-4, weight_decay=0.01), "
          f"sche_args=dict(epochs={args.recovery_ce_epochs}), "
          "other_args=dict(num_classes=NUM_CLASSES, log_interval=50))")
    cal = ("dict(type='CalibrationHook', priority=40, num_batches=4, "
           f"batch_size=32, image_size={size}, dataset=DATASET)")
    header = (
        "# Written by convnet_approximater_tpu_torch.plan_serving --emit-recovery.\n"
        "# REPLACE the DATASET/NUM_CLASSES placeholders with the real training\n"
        "# data, set model.init_cfg (see below), then run:\n"
        "#   python -m convnet_approximater_tpu_torch.main --config <this file>\n"
        "DATASET = dict(type='Synthetic', num_samples=512,\n"
        f"               image_size={tuple(args.input_size)}, num_classes=10)  # FILL\n"
        "NUM_CLASSES = 10  # FILL\n")
    seen = set()
    for r in plan["report"]:
        lossy = r["name"] == plan["winner"] or "needs_recovery" in (r["note"] or "")
        if not lossy or r["name"] in seen:
            continue
        seen.add(r["name"])
        stages = recovery_plan(r["name"], v3_energy=args.v3_energy)
        if not stages:
            continue
        safe = r["name"].replace("/", "-").replace("+", "_").replace("=", "")
        paths = []
        acc_passes = []  # a later stage's checkpoint loads only where every earlier pass replays
        for i, st in enumerate(stages):
            if st.get("structure_pass"):
                acc_passes.append(st["structure_pass"])
            chain = ("the trained dense checkpoint" if i == 0 else
                     f"the stage-{i} run's saved last.ckpt.npz")
            replay = f"structure_passes = {acc_passes!r}\n" if acc_passes else ""
            if st.get("qat"):
                body = (f"{header}_base_ = [r'{base}']\n"
                        f"# stage {i + 1}/{len(stages)}: QAT (int8's recovery) — "
                        f"model.init_cfg = {chain}\n"
                        "model = dict(init_cfg=None)  # FILL\n"
                        "app = dict(type='Dummy')\nfilters = []\n"
                        f"{replay}"
                        "hooks = [dict(type='PrepareQAT', priority=48),\n"
                        f"         {ce}]\n")
            elif st.get("structure_pass"):
                body = (f"{header}_base_ = [r'{base}']\n"
                        f"# stage {i + 1}/{len(stages)}: {st['structure_pass']['fn']} (a "
                        f"structure pass the Runner replays) — model.init_cfg = {chain}\n"
                        "model = dict(init_cfg=None)  # FILL\n"
                        "app = dict(type='Dummy')\nfilters = []\n"
                        f"structure_passes = {acc_passes!r}\n"
                        f"hooks = [{ce}]\n")
            else:
                body = (f"{header}_base_ = [r'{base}']\n"
                        f"# stage {i + 1}/{len(stages)}: {st['app']['type']} recovery — "
                        f"model.init_cfg = {chain}\n"
                        "model = dict(init_cfg=None)  # FILL\n"
                        f"{replay}"
                        f"app = {st['app']!r}\n"
                        f"filters = {st['filters']!r}\n"
                        "hooks = ["
                        + (f"{cal},\n         " if st["calibration"] else "")
                        + f"{l2},\n         {ce}]\n")
            p = os.path.join(args.emit_recovery, f"recover_{safe}_stage{i + 1}.py")
            with open(p, "w") as f:
                f.write(body)
            paths.append(p)
        logger.info(f"recovery chain for '{r['name']}' ({len(paths)} "
                    f"stage{'s' if len(paths) > 1 else ''}): " + " -> ".join(paths))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="serving planner (PyTorch port)")
    ap.add_argument("--config", required=True,
                    help="any config with a `model` key (its app and filters are ignored: "
                         "planning starts from the dense model)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--input-size", type=int, nargs=3, default=(224, 224, 3))
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                    help="serving type (float32 only in the port)")
    ap.add_argument("--min-agree", type=float, default=0.9)
    ap.add_argument("--v3-energy", type=float, default=0.9)
    ap.add_argument("--out", default="serving_plan.json")
    ap.add_argument("--export", default=None, metavar="ARTIFACT",
                    help="export the winning surface as a torch.export artifact")
    ap.add_argument("--norm-mean", type=float, nargs=3, default=(0.485, 0.456, 0.406),
                    help="preprocessing mean recorded in the exported .meta.json")
    ap.add_argument("--norm-std", type=float, nargs=3, default=(0.229, 0.224, 0.225))
    ap.add_argument("--emit-recovery", default=None, metavar="DIR",
                    help="write recovery fine-tune configs for the winner and every "
                         "needs_recovery surface")
    ap.add_argument("--recovery-epochs", type=int, default=20,
                    help="L2-reconstruction epochs in the written configs")
    ap.add_argument("--recovery-ce-epochs", type=int, default=10,
                    help="cross-entropy epochs in the written configs")
    ap.add_argument("--skip", default=None, metavar="SUBSTR[,SUBSTR...]",
                    help="drop the candidates whose name holds one of these")
    ap.add_argument("--only", default=None, metavar="SUBSTR[,SUBSTR...]",
                    help="keep only the candidates whose name holds one of these "
                         "(dense is always kept)")
    ap.add_argument("--retime", action="store_true",
                    help="time every candidate even when --out holds a plan of this model")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--seed", type=int, default=None, help="seed of the random weights")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    logger = build_logger()
    init_cfg(args.config)
    cfg = get_cfg()
    seed = args.seed if args.seed is not None else (cfg.seed or 0)
    dtype = DTYPES[args.dtype]

    def make():
        model = build_model(cfg.model)
        init_weights(model, torch.Generator().manual_seed(seed))
        model.load_init_cfg()
        model.to(device)
        if args.checkpoint:
            model.load_state_dict(read_checkpoint(args.checkpoint, device))
        return channels_last(model).eval()

    if not args.checkpoint:
        logger.warning("no --checkpoint: planning over random weights (the times hold; the "
                       "agreement gate is not accuracy-grade without a trained model)")
    shape = (args.batch,) + tuple(args.input_size)
    cands = default_candidates(make(), dtype=dtype, v3_energy=args.v3_energy, input_shape=shape)
    if args.skip:
        subs = [t for t in args.skip.split(",") if t]
        cands = [(n, b) for n, b in cands if not any(t in n for t in subs)]
    if args.only:
        subs = [t for t in args.only.split(",") if t]
        cands = [(n, b) for n, b in cands if n.startswith("dense/") or any(t in n for t in subs)]
    logger.info("candidates: " + ", ".join(n for n, _ in cands))
    # a persisted plan replays only for the same model, shape and type
    identity = {"model": {k: v for k, v in dict(cfg.model).items() if k != "init_cfg"},
                "batch": args.batch, "input_size": list(args.input_size), "dtype": args.dtype}
    identity = json.loads(json.dumps(identity, default=str))
    reuse = None
    if not args.retime and os.path.exists(args.out):
        with open(args.out) as f:
            stored = json.load(f)
        if stored.get("identity") == identity:
            reuse = stored
            logger.info(f"replaying the plan in {args.out} (--retime to measure again)")
        else:
            logger.warning(f"{args.out} holds a plan of another model, shape or type; timing")
    plan = plan_serving(make, shape, dtype=dtype, candidates=cands, min_agree=args.min_agree,
                        seed=seed, reuse_plan=reuse)

    logger.info(f"{'surface':<40}{'ms':>10}{'img/s':>10}{'agree':>8}{'qualified':>10}  note")
    for r in plan["report"]:
        ms = f"{r['ms']:.3f}" if r["ms"] is not None else "-"
        ips = f"{r['img_per_s']:.1f}" if r["img_per_s"] else "-"
        ag = f"{r['agree']:.3f}" if r["agree"] is not None else "-"
        logger.info(f"{r['name']:<40}{ms:>10}{ips:>10}{ag:>8}{str(r['qualified']):>10}  "
                    f"{r['note']}")
    logger.info(f"winner: {plan['winner']} ({plan['speedup_vs_dense']:.3f}x vs "
                f"dense/{plan['dtype']})")
    with open(args.out, "w") as f:
        json.dump(dict(plan_to_json(plan), identity=identity), f, indent=2)
    logger.info(f"plan -> {args.out}")
    if args.emit_recovery:
        emit_recovery_configs(args, plan, logger)
    if args.export:
        H, W, C = args.input_size
        x = torch.randn(args.batch, C, H, W, generator=torch.Generator().manual_seed(seed))
        meta = serving_meta(args.norm_mean, args.norm_std, plan["dtype"], [args.batch, C, H, W],
                            surface=plan["winner"], speedup_vs_dense=plan["speedup_vs_dense"])
        data, _, err = write_artifact(plan["model"], x.to(device).contiguous(
            memory_format=torch.channels_last), args.export, meta)
        logger.info(f"winner '{plan['winner']}' exported -> {args.export} ({len(data)} bytes, + "
                    f".params.npz, .meta.json; artifact max err {err:.2e})")
        plan["export"] = args.export
    return plan


if __name__ == "__main__":
    main()
