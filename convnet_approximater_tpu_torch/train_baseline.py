"""Train a baseline from scratch (port of ``scripts/train_baseline.py``).

    python -m convnet_approximater_tpu_torch.train_baseline [--model AlexNet]
        [--num-classes 10] [--dataset CIFAR10 --data-root DIR] [--image-size 224 224]
        [--epochs 20] [--batch-size 128] [--lr 1e-3] [--work-dir work_dirs/baseline]
        [--device cuda] [--coordinator HOST:PORT --num-processes N --process-id I]
    torchrun --nproc-per-node=N -m convnet_approximater_tpu_torch.train_baseline ...

trains the model from random weights (seed 0) with ``TrainHelper`` on
``Synthetic`` data unless a dataset is named, and writes its checkpoints
(``model_best.ckpt.npz``, the flat npz layout that ``model.init_cfg`` reads)
to the work dir.  Across processes (``torchrun`` or the three flags, as
``main.py`` takes them) the ranks train data-parallel, ``--batch-size`` being
the global batch, and only the main process writes the work dir.
``--device`` defaults to ``cuda`` and fails when no CUDA device is present;
the CPU runs only when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from convnet_approximater_tpu_torch.classification import TrainHelper
from convnet_approximater_tpu_torch.models import build_model
from convnet_approximater_tpu_torch.nn import init_weights
from convnet_approximater_tpu_torch.parallel import initialize_distributed
from convnet_approximater_tpu_torch.utils import build_logger


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train a baseline from scratch (PyTorch port)")
    ap.add_argument("--model", default="AlexNet")
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--dataset", default=None, help="DATASET type (e.g. CIFAR10)")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--image-size", type=int, nargs=2, default=(224, 224))
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--work-dir", default="work_dirs/baseline")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--coordinator", default=None,
                    help="process group address (host:port); torchrun sets its own")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    device = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                    device=device)
    build_logger()
    model = build_model(dict(type=args.model, num_classes=args.num_classes))
    init_weights(model, torch.Generator().manual_seed(0))
    dataset = dict(type=args.dataset, root=args.data_root) if args.dataset else None
    return TrainHelper(model, dict(
        dataset=dataset, num_classes=args.num_classes, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, image_size=tuple(args.image_size),
        work_dir=args.work_dir,
    ), device=device).train()


if __name__ == "__main__":
    main()
