"""Re-wrap a flat checkpoint into the Substitution-wrapped key space (the
counterpart of ``scripts/ckpt_converter/add_substitution.py``).

    python -m convnet_approximater_tpu_torch.ckpt_converter.add_substitution SRC DST \\
        --paths backbone.features.3 ... [--branch new|old]

For every switchable dotted path, the ``params/`` and ``state/`` leaves under
it move to ``<path>/<branch>/`` (with ``keep_other``, a copy also goes under
the other branch), so that a pipeline that holds Substitutions can load a
checkpoint saved after PostProcess.  ``SRC`` is a flat ``.npz`` or a sharded
``.ckpt.dcp`` directory of either package's key space (the port's checkpoints
use the JAX package's); ``DST`` is written as ``.npz``.
"""

from __future__ import annotations

import argparse

from convnet_approximater_tpu_torch.utils.serialize import (flatten_tree, load_ckpt, save_model,
                                                            unflatten_tree)


def add_substitution(tree: dict, switchable_paths, branch: str = "new",
                     keep_other: bool = False) -> dict:
    flat = flatten_tree(tree)
    out = {}
    prefixes = [p.replace(".", "/") for p in switchable_paths]
    for key, v in flat.items():
        matched = next((p for p in prefixes if key.startswith(("params/" + p + "/",
                                                                "state/" + p + "/"))), None)
        if matched is None:
            out[key] = v
            continue
        head, rest = key.split(matched + "/", 1)
        out[f"{head}{matched}/{branch}/{rest}"] = v
        if keep_other:
            other = "old" if branch == "new" else "new"
            out[f"{head}{matched}/{other}/{rest}"] = v
    return unflatten_tree(out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="wrap switchable subtrees of a checkpoint under "
                                             "a Substitution branch (PyTorch port)")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--paths", nargs="+", required=True, help="switchable dotted paths")
    ap.add_argument("--branch", default="new", choices=("new", "old"))
    args = ap.parse_args(argv)
    tree = add_substitution(load_ckpt(args.src), args.paths, args.branch)
    save_model(tree, args.dst)
    print(f"wrote {args.dst}")
    return tree


if __name__ == "__main__":
    main()
