"""What a workload's recipe does to a model, as the yardstick and the plain
reference read it.

A recipe is the list of steps a workload file gives, in order: ``{"app": {...},
"filters": [...]}`` applies one of the port's apps through
``deploy_planner.apply_app``, ``{"pass": name, ...}`` runs ``deploy.<name>``.
The harness hands the steps to the program as they are; this module turns them
into the few facts the counts and the reference need, and refuses a step it
does not know, so that a new rewrite cannot pass unchecked.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# passes that leave the eval forward's function as it is (up to the order of sums)
EXACT_PASSES = ("fold_batchnorm", "enable_pw_matmul")


@dataclass(frozen=True)
class Rewrites:
    msca_rank: Optional[int] = None        # MscaRep(decomp=r, fix=True): the bank's rank-r kernel
    ffn_merged: Tuple[int, ...] = ()       # FfnRep: the FFNs merged, 1-based, stage-major
    dw_rank: Optional[int] = None          # DwSepRep(ranks=r) on the depthwise 7x7s
    int8_calib_batches: int = 0            # quantize_int8 on this many calibration batches


def read_recipe(recipe) -> Rewrites:
    facts = {}
    for step in recipe:
        if "app" in step:
            app = dict(step["app"])
            kind = app.pop("type")
            filters = step.get("filters", [])
            if kind == "MscaRep":
                if not app.get("fix") or app.get("decomp_conv0") or app.get("decomp", 0) < 1:
                    raise ValueError(f"the reference covers MscaRep(decomp >= 1, fix=True) only: "
                                     f"{step}")
                facts["msca_rank"] = int(app["decomp"])
            elif kind == "FfnRep":
                if not app.get("fix", True):
                    raise ValueError(f"the reference covers FfnRep(fix=True) only: {step}")
                if [f["type"] for f in filters] != ["IndicesFilter"]:
                    raise ValueError(f"FfnRep takes one IndicesFilter here: {step}")
                facts["ffn_merged"] = tuple(sorted(int(i) for i in filters[0]["indices"]))
            elif kind == "DwSepRep":
                if not isinstance(app.get("ranks"), int):
                    raise ValueError(f"the reference covers DwSepRep(ranks=<int>) only: {step}")
                facts["dw_rank"] = int(app["ranks"])
            else:
                raise ValueError(f"no reference for the app {kind}")
        elif step.get("pass") in EXACT_PASSES:
            continue
        elif step.get("pass") == "quantize_int8":
            facts["int8_calib_batches"] = int(step["calib_batches"])
        else:
            raise ValueError(f"no reference for the recipe step {step}")
    return Rewrites(**facts)
