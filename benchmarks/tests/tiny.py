"""Tiny cells for the CPU tests: the harness's own files at small sizes."""

import copy
import json

from benchkit import spec

MSCAN = dict(in_channels=3, num_channels=[8, 16, 24, 32], num_blocks=[1, 2, 1, 1],
             exp_ratios=[2, 2, 2, 2], num_classes=16, k1_size=5, k_sizes=[7, 11, 21],
             ffn_kernel=3, bn_eps=1e-5, ln_eps=1e-5, gelu="tanh")
CONVNEXT = dict(in_channels=3, depths=[1, 2, 1, 1], dims=[8, 16, 24, 32], num_classes=16,
                stem_stride=4, kernel_size=7, mlp_ratio=4, ln_eps=1e-6, gelu="tanh")
TRAFFIC = dict(job="serve", batch=2, image_size=32, in_flight=2, pool_batches=3,
               check_batches=2, trace_batches=2, tf32=False, mean=[0.485, 0.456, 0.406],
               std=[0.229, 0.224, 0.225])
CELLS = {"mscan_t.serve_f32_b128": ("mscan", MSCAN), "convnext_t.serve_int8_b128": ("convnext", CONVNEXT)}


def cell(name: str, **traffic) -> spec.Cell:
    """The cell ``name`` of BENCHMARK.json with its recipe, limits and metrics,
    at a tiny model and traffic."""
    full = spec.load_cell(name)
    fam, model = CELLS[name]
    out = copy.deepcopy(full)
    out.config = dict(family=fam, model=copy.deepcopy(model))
    out.traffic = dict(RECOVER if full.traffic["job"] == "recover" else TRAFFIC, **traffic)
    return out


def dump(path, obj):
    path.write_text(json.dumps(obj))

RECOVER = dict(job="recover", batch=2, image_size=32, in_flight=2, pool_batches=4, trace_steps=2,
               tf32=False, mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
SERVE_CELLS = sorted(CELLS)
CELLS["convnext_t.recover_r1_b32"] = ("convnext", CONVNEXT)
