"""Deploy-mode comparison CLI of the PyTorch port (the counterpart of
``scripts/low_rank_exp_inference.py``).

    python -m convnet_approximater_tpu_torch.inference --config <cfg> \\
        --checkpoint <ckpt> [--batch 16] [--decomp] [--never-lose] \\
        [--quantize int8] [--eval-dataset TYPE --eval-root DIR] [--device cuda]

times, counts and (with ``--eval-dataset``) evaluates the config's original
model beside the compressed one loaded from the checkpoint (the Runner's
``.pt`` or a flat ``.npz``) in its served form, through
:class:`~convnet_approximater_tpu_torch.runner.ClassInference`.  ``--device``
defaults to ``cuda`` and fails when no CUDA device is present; the CPU runs
only when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import torch

from convnet_approximater_tpu_torch.runner import ClassInference
from convnet_approximater_tpu_torch.utils import build_logger, get_cfg, init_cfg, update_cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="original against compressed model (PyTorch port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--decomp", action="store_true", help="also report after decomp()")
    ap.add_argument("--never-lose", action="store_true",
                    help="serve each low-rank layer factored only where the model gains")
    ap.add_argument("--eval-dataset", default=None, help="DATASET registry type, e.g. CIFAR10")
    ap.add_argument("--eval-root", default=None)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="serving type: float32 (the default, as the JAX CLI's) or bfloat16")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="int8 post-training quantization of the approximated model")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--seed", type=int, default=None, help="seed of the random weights")
    ap.add_argument("--work-dir", default=None,
                    help="where never_lose_decisions.json goes (default: the config's)")
    return ap.parse_args(argv)


def main(argv=None) -> ClassInference:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    build_logger()
    init_cfg(args.config)
    cfg = get_cfg()
    work_dir = args.work_dir or cfg.work_dir or "."
    os.makedirs(work_dir, exist_ok=True)
    update_cfg(checkpoint=args.checkpoint, work_dir=work_dir)
    eval_cfg = None
    if args.eval_dataset:
        eval_cfg = dict(dataset=dict(type=args.eval_dataset, root=args.eval_root),
                        batch_size=args.batch, input_size=(224, 224, 3))
    generator = torch.Generator().manual_seed(args.seed) if args.seed is not None else None
    inference = ClassInference(checkpoint=args.checkpoint, batch_size=args.batch,
                               do_decomp=args.decomp, eval_cfg=eval_cfg, device=device,
                               generator=generator, never_lose=args.never_lose,
                               dtype=args.dtype, quantize=args.quantize)
    inference.run()
    return inference


if __name__ == "__main__":
    main()
