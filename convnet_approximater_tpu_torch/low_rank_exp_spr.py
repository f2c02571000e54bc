"""Speed-up ratio of the scheme-1 low-rank conv against ``num_bases`` (the
counterpart of ``scripts/low_rank_exp_spr.py``).

    python -m convnet_approximater_tpu_torch.low_rank_exp_spr [--batch 64] \\
        [--bases 2 4 8 16 32] [--out work_dirs/spr] [--device cuda]

For each of AlexNet's four substitutable convs at 224^2 (``ALEXNET_SHAPES``)
it builds the dense conv (weights from ``--seed``) and, per M in ``--bases``,
``LowRankExpV1(num_bases=(M,), do_decomp=True)`` on it as the JAX script does
(SVD start, no ALS iteration, the separable form), and times both with the
port's default timer (``hooks/inference_time_hook.py::forward_times``: on the
card a ``compile_serving`` graph replayed back to back, the dense conv on
cuDNN and the low-rank layer on ``lowrank_conv``; on the CPU the eager
median).  It writes the JAX script's CSV, ``shape,num_bases,theoretical_spr,
measured_spr`` with ``theoretical_spr = d^2 C N / (C M (2d + N))`` and
``measured_spr`` = dense ms / low-rank ms, and the plot ``spr.png`` where
matplotlib is installed.  On the card a row whose shape ``lowrank_conv.plan``
finds no shared-memory plan for is not served: its ``measured_spr`` reads
``refused`` and the plan's message is printed and returned.  ``--device``
defaults to ``cuda`` and fails when no CUDA device is present; the CPU runs
only when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import torch

from convnet_approximater_tpu_torch.core import LowRankExpV1
from convnet_approximater_tpu_torch.hooks.inference_time_hook import forward_times
from convnet_approximater_tpu_torch.nn import Conv2d, channels_last, init_weights
from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops

# (in_channels, out_channels, kernel, stride, padding, feature H = W) of AlexNet's 4
# substitutable convs at a 224x224 input
ALEXNET_SHAPES = [
    (64, 192, 5, 1, 2, 27),
    (192, 384, 3, 1, 1, 13),
    (384, 256, 3, 1, 1, 13),
    (256, 256, 3, 1, 1, 13),
]


def theoretical_spr(C: int, N: int, d: int, M: int) -> float:
    """The JAX script's theoretical speed-up: the dense conv's multiply-adds
    per pixel over the separable bases' and the mix's."""
    return (d * d * C * N) / (C * M * (2 * d + N))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="low-rank speed-up ratio against num_bases "
                                             "(PyTorch port)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--bases", type=int, nargs="+", default=[2, 4, 8, 16, 32])
    ap.add_argument("--out", default="work_dirs/spr")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default), cuda:N or cpu")
    return ap.parse_args(argv)


def low_rank_of(conv: Conv2d, M: int, generator: torch.Generator):
    """``LowRankExpV1(num_bases=(M,), do_decomp=True)`` on ``conv``, as the JAX
    script applies it: the separable ``LowRankExpConvV1``, in eval mode."""
    app = LowRankExpV1(num_bases=(M,), max_iter=0, lmda_length=1, min_lmda=0, max_lmda=0,
                       init_method="svd", do_decomp=True)
    sub = app.initialize(conv, generator)
    app.optimize(sub)
    return app.postprocess(sub).eval()


def plot(rows, path: str) -> bool:
    """The JAX script's plot of measured and theoretical ratios per shape;
    False where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    for shape in dict.fromkeys(r["shape"] for r in rows):
        pts = sorted((r["num_bases"], r["theoretical_spr"], r["measured_spr"])
                     for r in rows if r["shape"] == shape and r["measured_spr"] is not None)
        ax.plot([m for m, _, _ in pts], [v for _, _, v in pts], "-o", label=f"{shape} measured")
        ax.plot([m for m, _, _ in pts], [v for _, v, _ in pts], "--", label=f"{shape} theory")
    ax.set_xlabel("num_bases")
    ax.set_ylabel("speed-up ratio")
    ax.legend(fontsize=6)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         f"(pass --device cpu to run on the CPU)")
    os.makedirs(args.out, exist_ok=True)
    gen = torch.Generator().manual_seed(args.seed)
    rows, lines = [], ["shape,num_bases,theoretical_spr,measured_spr"]
    for (C, N, d, s, p, hw) in ALEXNET_SHAPES:
        conv = Conv2d(C, N, d, stride=s, padding=p)
        init_weights(conv, gen)
        conv = channels_last(conv.to(device)).eval()
        size = (args.batch, hw, hw, C)
        dense = forward_times(conv, size)
        for M in args.bases:
            row = dict(shape=f"{C}x{N}x{d}", C=C, hw=hw, num_bases=M,
                       theoretical_spr=theoretical_spr(C, N, d, M),
                       dense_ms=dense["ms"], dense_eager_ms=dense["eager_median_ms"],
                       measured_spr=None, refused=None)
            if device.type == "cuda":
                try:
                    lowrank_ops.plan(args.batch, hw, hw, C, M, N, (d, d), (s, s), (p, p))
                except ValueError as e:
                    row["refused"] = str(e)
            if row["refused"] is None:
                module = low_rank_of(conv, M, gen)
                low = forward_times(module, size)
                row.update(module=module, lowrank_ms=low["ms"],
                           lowrank_eager_ms=low["eager_median_ms"],
                           measured_spr=dense["ms"] / low["ms"])
            rows.append(row)
            meas = "refused" if row["refused"] else f"{row['measured_spr']:.3f}"
            lines.append(f"{row['shape']},{M},{row['theoretical_spr']:.3f},{meas}")
            print(lines[-1] + (f"  ({row['refused']})" if row["refused"] else
                               f"  (dense {row['dense_ms']:.4f} ms, low-rank "
                               f"{row['lowrank_ms']:.4f} ms)"), flush=True)
    csv_path = os.path.join(args.out, "spr.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {csv_path}")
    png = os.path.join(args.out, "spr.png")
    if plot(rows, png):
        print(f"wrote {png}")
    else:
        png = None
        print("(plot skipped: matplotlib is not installed)")
    refused = [r for r in rows if r["refused"]]
    if refused:
        print(f"{len(refused)} of {len(rows)} rows refused by lowrank_conv's plan")
    return dict(rows=rows, csv=csv_path, png=png, refused=refused)


if __name__ == "__main__":
    main()
