"""Pipeline CLI of the PyTorch port.

    python -m convnet_approximater_tpu_torch.main --config <cfg> [--device cuda]
        [--seed 42] [--work-dir DIR]

reads the repository's config files unchanged and runs the 4-phase Runner on
one device.  ``--device`` defaults to ``cuda`` and fails when no CUDA device is
present; the CPU runs only when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from convnet_approximater_tpu_torch.runner import Runner
from convnet_approximater_tpu_torch.utils import (build_logger, get_cfg, get_rank, init_cfg,
                                                  update_cfg)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ConvNet approximation pipeline (PyTorch port)")
    p.add_argument("--config", required=True, help="config file (.py/.yaml with _base_ support)")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--seed", type=int, default=42, help="seed of the random weights")
    p.add_argument("--work-dir", default=None)
    return p.parse_args(argv)


def main(argv=None) -> Runner:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    init_cfg(args.config)
    cfg = get_cfg()
    work_dir = args.work_dir or os.path.join(cfg.work_dir, time.strftime("%Y%m%d_%H%M%S"))
    if get_rank() == 0:
        os.makedirs(work_dir, exist_ok=True)
        build_logger(os.path.join(work_dir, "run.log"))
    update_cfg(work_dir=work_dir, config_name=cfg.name, seed=args.seed)
    runner = Runner(device=device, generator=torch.Generator().manual_seed(args.seed))
    runner.run()
    return runner


if __name__ == "__main__":
    main()
