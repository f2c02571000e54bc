"""Unwrap a Substitution-wrapped checkpoint back to the flat key space (the
counterpart of ``scripts/ckpt_converter/remove_substitution.py``).

    python -m convnet_approximater_tpu_torch.ckpt_converter.remove_substitution SRC DST \\
        [--keep new|old]

Leaves under ``<path>/<keep>/`` collapse onto ``<path>/``; the other branch's
leaves are dropped.  ``SRC`` is a flat ``.npz`` or a sharded ``.ckpt.dcp``
directory; ``DST`` is written as ``.npz``.
"""

from __future__ import annotations

import argparse

from convnet_approximater_tpu_torch.utils.serialize import (flatten_tree, load_ckpt, save_model,
                                                            unflatten_tree)


def remove_substitution(tree: dict, keep_branch: str = "new") -> dict:
    flat = flatten_tree(tree)
    out = {}
    drop = "old" if keep_branch == "new" else "new"
    for key, v in flat.items():
        if f"/{drop}/" in key:
            continue
        out[key.replace(f"/{keep_branch}/", "/")] = v
    return unflatten_tree(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="collapse a checkpoint's Substitution branches "
                                             "(PyTorch port)")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--keep", default="new", choices=("new", "old"))
    args = ap.parse_args(argv)
    tree = remove_substitution(load_ckpt(args.src), args.keep)
    save_model(tree, args.dst)
    print(f"wrote {args.dst}")
    return tree


if __name__ == "__main__":
    main()
