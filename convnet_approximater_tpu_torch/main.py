"""Pipeline CLI of the PyTorch port.

    python -m convnet_approximater_tpu_torch.main --config <cfg> [--device cuda]
        [--seed 42] [--work-dir DIR] [--checkpoint CKPT] [--skip-optim] [--skip-post]
        [--coordinator HOST:PORT --num-processes N --process-id I]
    torchrun --nproc-per-node=N -m convnet_approximater_tpu_torch.main --config <cfg>

reads the repository's config files unchanged and runs the 4-phase Runner.
Across processes (one per device: ``torchrun``, the counterpart of the
reference's ``dist_main.sh``, or the three flags) each rank joins the process
group first (``parallel.initialize_distributed``: NCCL on the cards, each
rank on its own, gloo with ``--device cpu``), seeds Python and numpy with
``seed + rank``, and only the main process makes the work dir and writes the
log; a fine-tune hook then trains data-parallel over the ranks from the
first rank's weights (``L2Reconstruct``'s ``use_mesh``, ``dataset_args.batch_size``
the global batch), its npz checkpoints written by the main process alone.  ``--checkpoint`` is deploy mode: the app's sites are built as
their bare targets and the checkpoint (the Runner's ``.pt`` or a flat
``.npz``) loads into them, with Optimize and PostProcess skipped.
``--device`` defaults to ``cuda`` and fails when no CUDA device is present;
the CPU runs only when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from convnet_approximater_tpu_torch.parallel import initialize_distributed, is_main_process
from convnet_approximater_tpu_torch.runner import Runner
from convnet_approximater_tpu_torch.utils import (build_logger, get_cfg, get_rank, init_cfg,
                                                  update_cfg)
from convnet_approximater_tpu_torch.utils.random import random_seed


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ConvNet approximation pipeline (PyTorch port)")
    p.add_argument("--config", required=True, help="config file (.py/.yaml with _base_ support)")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    p.add_argument("--seed", type=int, default=42, help="seed of the random weights")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--checkpoint", default=None, help="deploy mode: load this checkpoint")
    p.add_argument("--skip-optim", action="store_true")
    p.add_argument("--skip-post", action="store_true")
    p.add_argument("--coordinator", default=None,
                   help="process group address (host:port); torchrun sets its own")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None) -> Runner:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    device = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                    device=device)
    init_cfg(args.config)
    cfg = get_cfg()
    work_dir = args.work_dir or os.path.join(cfg.work_dir, time.strftime("%Y%m%d_%H%M%S"))
    if is_main_process():
        os.makedirs(work_dir, exist_ok=True)
        build_logger(os.path.join(work_dir, "run.log"))
    generator = random_seed(args.seed, get_rank())
    deploy = args.checkpoint is not None
    update_cfg(work_dir=work_dir, config_name=cfg.name, checkpoint=args.checkpoint,
               seed=args.seed)
    runner = Runner(device=device, generator=generator, deploy=deploy,
                    skip_optim=args.skip_optim or deploy, skip_post=args.skip_post or deploy)
    runner.run()
    return runner


if __name__ == "__main__":
    main()
