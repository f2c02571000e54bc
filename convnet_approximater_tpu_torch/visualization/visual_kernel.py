"""Kernel grids of a checkpoint (the counterpart of
``scripts/visualization/visual_kernel.py``).

    python -m convnet_approximater_tpu_torch.visualization.visual_kernel CKPT [CKPT ...] \\
        --path backbone.layers.0.1.0.attn.spatial_gating_unit.sd_convs [--out work_dirs/kernels]

reads each checkpoint (a flat ``.npz`` or a sharded ``.ckpt.dcp`` directory,
in the JAX package's key space, which the port's checkpoints use), takes the
per-channel spatial kernels (C, kh, kw) at the dotted module path
(:func:`extract_kernels`: a depthwise conv's weight, or a ``CascadeConv``'s
effective kernel ``v ⊗ h``) and writes them as an image grid,
``<out>/<checkpoint name without its last suffix>.png``, or the kernels as ``.npy`` where matplotlib
is not installed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from convnet_approximater_tpu_torch.utils.serialize import flatten_tree, load_ckpt


def extract_kernels(tree: dict, path: str) -> np.ndarray:
    """The per-channel spatial kernels (C, kh, kw) at dotted module ``path``: a
    depthwise conv (``weight`` (kh, kw, 1, C)), or a CascadeConv (``conv1``
    (1, kw, 1, C) then ``conv2`` (kh, 1, 1, C): the product ``v ⊗ h``)."""
    flat = flatten_tree(tree)
    prefix = "params/" + path.replace(".", "/")
    if f"{prefix}/weight" in flat:
        w = np.asarray(flat[f"{prefix}/weight"])  # (kh, kw, 1, C)
        return np.transpose(w[:, :, 0, :], (2, 0, 1))
    if f"{prefix}/conv1/weight" in flat:
        h = np.asarray(flat[f"{prefix}/conv1/weight"])[0, :, 0, :]  # (kw, C)
        v = np.asarray(flat[f"{prefix}/conv2/weight"])[:, 0, 0, :]  # (kh, C)
        return np.einsum("hc,wc->chw", v, h)
    raise KeyError(f"no kernel found under {path}")


def grid_plot(kernels: np.ndarray, out_path: str, max_channels: int = 64) -> str:
    """The first ``max_channels`` kernels as a grid of images at ``out_path``
    (``.png``); without matplotlib the kernels go to ``.npy`` beside it.
    Returns the path written."""
    try:
        import matplotlib
    except ImportError:
        out_path = os.path.splitext(out_path)[0] + ".npy"
        np.save(out_path, kernels[:max_channels])
        print(f"matplotlib unavailable; wrote {out_path}")
        return out_path
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    C = min(kernels.shape[0], max_channels)
    cols = int(np.ceil(np.sqrt(C)))
    rows = int(np.ceil(C / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(cols, rows))
    for i in range(rows * cols):
        ax = axes.flat[i] if rows * cols > 1 else axes
        ax.axis("off")
        if i < C:
            ax.imshow(kernels[i], cmap="viridis")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    print(f"wrote {out_path}")
    return out_path


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description="plot a checkpoint's depthwise or cascade kernels "
                                             "(PyTorch port)")
    ap.add_argument("ckpts", nargs="+", help="checkpoints: .ckpt.npz files or .ckpt.dcp "
                                             "directories")
    ap.add_argument("--path", required=True,
                    help="dotted module path of the kernel, e.g. "
                         "backbone.layers.0.1.0.attn.spatial_gating_unit.sd_convs")
    ap.add_argument("--out", default="work_dirs/kernels")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    written = []
    for ckpt in args.ckpts:
        kernels = extract_kernels(load_ckpt(ckpt), args.path)
        name = os.path.splitext(os.path.basename(ckpt.rstrip("/")))[0]
        written.append(grid_plot(kernels, os.path.join(args.out, f"{name}.png")))
    return written


if __name__ == "__main__":
    main()
