"""The approximation loop outside the Runner, and the serving planner (port of
``convnet_approximater_tpu/deploy_planner.py``).

:func:`apply_app` runs an app's four phases on a model in place.
:func:`plan_serving` builds each candidate serving surface of a model from a
fresh copy, times them like for like, gates each rewritten surface on its top-1
agreement with the dense float32 model on probe batches, and returns the
fastest qualified one with the report.  :func:`default_candidates` offers the
JAX package's candidates, by the same names and gates; :func:`recovery_plan`
maps a candidate's name to the fine-tune stages that would recover its lossy
rewrites.

The port plans in float32 only: another serving type raises
``NotImplementedError`` (bf16 is ROADMAP.md queue 1, item 7; the JAX planner's
default is bf16).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

from convnet_approximater_tpu_torch.core import Approximater
from convnet_approximater_tpu_torch.filters import (DenseKxKFilter, DepthwiseConvFilter,
                                                    ModuleFilter)
from convnet_approximater_tpu_torch.nn import Conv2d, channels_last
from convnet_approximater_tpu_torch.utils.logger import get_logger


def apply_app(model: nn.Module, app: Approximater, filters: Sequence[ModuleFilter] = (),
              generator: Optional[torch.Generator] = None,
              calib_batches: Optional[Iterable[torch.Tensor]] = None) -> int:
    """Register -> initialize -> optimize -> postprocess ``app`` on ``model`` in
    place, one site after another; returns the number of sites rewritten (0
    when the app found none).

    With ``calib_batches`` and an app that has ``set_calibration``, the loop
    takes the Runner's two-pass shape instead: initialize every site, run the
    batches down the ``old`` branches tapping each site's input
    (:func:`~convnet_approximater_tpu_torch.hooks.calibration.calibrate`, the
    work of ``CalibrationHook``), then optimize and postprocess each site.

    The new modules draw their random weights from ``generator`` (seed 0 when
    None) before the solve overwrites them, land on their source's device and
    training mode, and keep the model's ``channels_last`` weights.
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    model.register_switchable(app.src_type, list(filters))
    n = model.length_switchable
    if calib_batches is None or not hasattr(app, "set_calibration"):
        for idx in range(n):
            src = model.get_switchable_module(idx)
            sub = app.initialize(src, generator).train(src.training)
            model.set_switchable_module(idx, sub)
            app.optimize(sub)
            model.set_switchable_module(idx, channels_last(app.postprocess(sub)))
        return n

    from convnet_approximater_tpu_torch.hooks.calibration import calibrate

    subs = []
    for idx in range(n):
        src = model.get_switchable_module(idx)
        sub = app.initialize(src, generator).train(src.training)
        model.set_switchable_module(idx, sub)
        subs.append(sub)
    calibrate(model, app, calib_batches)
    for idx, sub in enumerate(subs):
        app.optimize(sub)
        model.set_switchable_module(idx, channels_last(app.postprocess(sub)))
    return n


class _NoTargets(Exception):
    """A candidate found nothing to rewrite: skip it, do not fail the plan."""


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _check_dtype(dtype: torch.dtype):
    if dtype != torch.float32:
        raise NotImplementedError(
            f"serving type {_dtype_name(dtype)}: the port plans float32 surfaces only "
            f"(bf16 end to end is ROADMAP.md queue 1, item 7)")


def _has_module(model: nn.Module, pred) -> bool:
    return any(isinstance(m, Conv2d) and pred(m) for m in model.modules())


def _nhwc(x: torch.Tensor) -> tuple:
    return (x.shape[0], x.shape[2], x.shape[3], x.shape[1])


def _build_int8(model, calib_batches):
    from convnet_approximater_tpu_torch.deploy import fold_batchnorm, quantize_int8

    fold_batchnorm(model)
    if quantize_int8(model, calib_batches) == 0:
        raise _NoTargets("no dense convs/Linears to quantize")
    return model


def default_candidates(probe_model: nn.Module, dtype: torch.dtype = torch.float32,
                       v3_energy: float = 0.9, dwsep_rank: int = 1, input_shape=None):
    """The candidate surfaces that apply to ``probe_model``'s structure: a list of
    ``(name, build)``, where ``build(model, generator, calib_batches) -> model``
    turns a fresh model into the candidate surface (new modules' random
    weights from ``generator``, calibration on ``calib_batches``).

    The names, their gates and each candidate's order of passes are the JAX
    package's.  ``input_shape`` (NHWC, the serving shape) is where the
    MSCA-rep candidates time their ``arbitrated_apply`` of FfnRep; without it
    they time at the calibration batch's shape.
    """
    from convnet_approximater_tpu_torch.core import (AttnPrune, DwSepRep, FfnPrune, FfnRep,
                                                     LowRankExpV3, LowRankExpV4, MlpPrune,
                                                     MscaRep)
    from convnet_approximater_tpu_torch.deploy import (arbitrated_apply, enable_pw_matmul,
                                                       fold_batchnorm, prune_chains,
                                                       prune_trunks)
    from convnet_approximater_tpu_torch.layers import MSCA
    from convnet_approximater_tpu_torch.models.convnext import ConvNeXtBlock
    from convnet_approximater_tpu_torch.models.mscan import FFN

    _check_dtype(dtype)
    has_dw = _has_module(probe_model, DepthwiseConvFilter().filter)
    has_dense = _has_module(probe_model, DenseKxKFilter().filter)
    mods = list(probe_model.modules())
    has_msca = any(isinstance(m, MSCA) for m in mods)
    has_ffn = any(isinstance(m, FFN) for m in mods)
    has_block = any(isinstance(m, ConvNeXtBlock) for m in mods)

    def build_dense(model, generator, calib):
        fold_batchnorm(model)  # the dense serving surface folds BN too
        return model

    def build_int8(model, generator, calib):
        return _build_int8(model, calib)

    def build_v3(model, generator, calib):
        if apply_app(model, LowRankExpV3(energy=v3_energy), [DenseKxKFilter()], generator) == 0:
            raise _NoTargets("no dense kxk convs")
        fold_batchnorm(model)  # through the mix_conv tails
        return model

    def build_tucker(model, generator, calib):
        if apply_app(model, LowRankExpV4(energy=v3_energy), [DenseKxKFilter()], generator) == 0:
            raise _NoTargets("no dense kxk convs")
        fold_batchnorm(model)  # through the out_conv tails
        return model

    def build_dwsep(model, generator, calib):
        if apply_app(model, DwSepRep(ranks=dwsep_rank), [DepthwiseConvFilter()], generator) == 0:
            raise _NoTargets("no depthwise convs")
        fold_batchnorm(model)
        return model

    def build_dwsep_int8(model, generator, calib):
        if apply_app(model, DwSepRep(ranks=dwsep_rank), [DepthwiseConvFilter()], generator) == 0:
            raise _NoTargets("no depthwise convs")
        # disjoint layers: the depthwise rewrite leaves the dense remainder to int8
        return _build_int8(model, calib)

    def build_mscarep(model, generator, calib):
        # MscaRep d1+fix+dconv0, then FfnRep arbitrated per stage at the serving
        # shape, then the BN fold (and the 1x1s as matmuls off float32)
        if apply_app(model, MscaRep(decomp=1, fix=True, decomp_conv0=True), [], generator) == 0:
            raise _NoTargets("no MSCA attention modules")
        from convnet_approximater_tpu_torch.hooks.inference_time_hook import forward_seconds

        shape = tuple(input_shape) if input_shape is not None else _nhwc(calib[0])
        arbitrated_apply(model, FfnRep(fix=True), [], shape, seed=generator.initial_seed(),
                         time_fn=lambda m, s: forward_seconds(m, s, num_iters=6, warmup=2),
                         group_fn=lambda name: name.rsplit(".", 3)[0], verbose=False)
        fold_batchnorm(model)
        if dtype != torch.float32:
            enable_pw_matmul(model)
        return model

    def build_ffnprune_rep(model, generator, calib):
        if apply_app(model, FfnPrune(keep_ratio=0.5, round_to=128), [], generator,
                     calib_batches=calib) == 0:
            raise _NoTargets("no conv-FFN modules")
        return build_mscarep(model, generator, calib)

    def build_quad_prune_rep(model, generator, calib):
        if prune_trunks(model, keep_ratio=0.5, round_to=64) == 0:
            raise _NoTargets("no prunable trunks")
        apply_app(model, AttnPrune(keep_ratio=0.5), [], generator, calib_batches=calib)
        apply_app(model, FfnPrune(keep_ratio=0.5, round_to=128), [], generator,
                  calib_batches=calib)
        return build_mscarep(model, generator, calib)

    def build_mlpprune(model, generator, calib):
        if apply_app(model, MlpPrune(keep_ratio=0.5, round_to=128), [], generator,
                     calib_batches=calib) == 0:
            raise _NoTargets("no ConvNeXt blocks")
        fold_batchnorm(model)
        return model

    def build_mlpprune_int8(model, generator, calib):
        if apply_app(model, MlpPrune(keep_ratio=0.5, round_to=128), [], generator,
                     calib_batches=calib) == 0:
            raise _NoTargets("no ConvNeXt blocks")
        return _build_int8(model, calib)

    def build_chainprune(model, generator, calib):
        if prune_chains(model, keep_ratio=0.5, round_to=64) == 0:
            raise _NoTargets("no prunable junctions")
        fold_batchnorm(model)
        return model

    def build_chainprune_int8(model, generator, calib):
        if prune_chains(model, keep_ratio=0.5, round_to=64) == 0:
            raise _NoTargets("no prunable junctions")
        return _build_int8(model, calib)

    def build_dwsep_mlpprune_int8(model, generator, calib):
        if apply_app(model, MlpPrune(keep_ratio=0.5, round_to=128), [], generator,
                     calib_batches=calib) == 0:
            raise _NoTargets("no ConvNeXt blocks")
        apply_app(model, DwSepRep(ranks=dwsep_rank), [DepthwiseConvFilter()], generator)
        return _build_int8(model, calib)

    def build_trunk_dwsep_mlpprune_int8(model, generator, calib):
        if prune_trunks(model, keep_ratio=0.5, round_to=128) == 0:
            raise _NoTargets("no trunks")
        return build_dwsep_mlpprune_int8(model, generator, calib)

    def build_trunkprune(model, generator, calib):
        if prune_trunks(model, keep_ratio=0.5, round_to=64) == 0:
            raise _NoTargets("no residual trunks")
        prune_chains(model, keep_ratio=0.5, round_to=64)
        fold_batchnorm(model)
        return model

    def build_trunkprune_int8(model, generator, calib):
        if prune_trunks(model, keep_ratio=0.5, round_to=64) == 0:
            raise _NoTargets("no residual trunks")
        prune_chains(model, keep_ratio=0.5, round_to=64)
        return _build_int8(model, calib)

    out = [(f"dense/{_dtype_name(dtype)}", build_dense), ("int8", build_int8)]
    if has_dense:
        out.append((f"v3/e={v3_energy}", build_v3))
        out.append((f"tucker/e={v3_energy}", build_tucker))
    if has_dw:
        out.append((f"dwsep/r={dwsep_rank}", build_dwsep))
        out.append((f"dwsep/r={dwsep_rank}+int8", build_dwsep_int8))
    if has_msca:
        out.append(("mscarep/d1+fix+dconv0+arb-ffnrep", build_mscarep))
    if has_ffn and has_msca:
        out.append(("ffnprune/0.5+mscarep", build_ffnprune_rep))
        if prune_trunks(probe_model, keep_ratio=0.5, round_to=64, dry_run=True) > 0:
            out.append(("trunk+attnprune+ffnprune/0.5+mscarep", build_quad_prune_rep))
    if has_block:
        out.append(("mlpprune/0.5", build_mlpprune))
        out.append(("mlpprune/0.5+int8", build_mlpprune_int8))
        if has_dw:
            out.append((f"dwsep/r={dwsep_rank}+mlpprune/0.5+int8", build_dwsep_mlpprune_int8))
            if callable(getattr(probe_model, "trunk_groups", None)):
                out.append((f"trunk+dwsep/r={dwsep_rank}+mlpprune/0.5+int8",
                            build_trunk_dwsep_mlpprune_int8))
    # plain-CNN junctions, gated on a dry count that leaves the probe model as it is
    has_chain = prune_chains(probe_model, keep_ratio=0.5, round_to=64, dry_run=True) > 0
    if has_chain and not (has_ffn or has_block):
        out.append(("chainprune/0.5", build_chainprune))
        out.append(("chainprune/0.5+int8", build_chainprune_int8))
        if prune_trunks(probe_model, keep_ratio=0.5, round_to=64, dry_run=True) > 0:
            out.append(("trunk+chainprune/0.5", build_trunkprune))
            out.append(("trunk+chainprune/0.5+int8", build_trunkprune_int8))
    return out


@torch.no_grad()
def _top1(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The class of each logit vector: dim 1 of (B, K) logits and of NCHW
    segmentation logits (per pixel) alike."""
    return model.eval()(x).argmax(dim=1)


def _agreement(model: nn.Module, probe_xs: Sequence[torch.Tensor],
               ref_top1: Sequence[torch.Tensor]) -> float:
    hits = total = 0
    for x, ref in zip(probe_xs, ref_top1):
        hits += int((_top1(model, x) == ref).sum())
        total += ref.numel()
    return hits / max(total, 1)


def _batches(shape, n: int, seed: int, device, scale: float = 1.0) -> List[torch.Tensor]:
    """``n`` normal batches of the NHWC ``shape`` from a generator seeded
    ``seed``, on ``device`` in ``channels_last``."""
    B, H, W, C = shape
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(B, C, H, W, generator=gen) * scale).to(device).contiguous(
        memory_format=torch.channels_last) for _ in range(n)]


def plan_serving(make: Callable[[], nn.Module], input_shape: Sequence[int],
                 dtype: torch.dtype = torch.float32, candidates=None, min_agree: float = 0.9,
                 seed: int = 0, calib_batches: Optional[List[torch.Tensor]] = None,
                 probe_batches: int = 2, num_iters: int = 10, warmup: int = 3,
                 time_fn: Optional[Callable] = None, verbose: bool = True,
                 reuse_plan: Optional[Dict] = None) -> Dict:
    """Plan the serving surface of the model ``make`` builds.

    Args:
      make: returns a fresh model (weights drawn or loaded), on its device, in
        eval mode: the rewrites edit it in place, so each candidate gets its own.
      input_shape: the NHWC serving shape with the batch, e.g. ``(64, 224, 224, 3)``.
      dtype: the serving type; float32 only in the port.
      candidates: ``[(name, build), ...]`` in place of :func:`default_candidates`.
      min_agree: the least top-1 agreement with the dense float32 model on the
        probe batches for a rewritten surface to qualify (the dense candidate
        always qualifies).
      seed: seeds each candidate's generator, and the generators of the
        calibration (4 batches, scale 0.8) and probe batches (``probe_batches``
        of them), each of at most 8 images of the serving shape.
      time_fn: ``time_fn(name, model, input_shape, dtype) -> seconds`` (a test
        injects one); the default is ``hooks.forward_seconds``: on the card
        the slope of a CUDA graph replayed back to back (``num_iters`` and 4x
        as many replays after ``warmup``), the eager median logged beside it.
      reuse_plan: a plan persisted by :func:`plan_to_json`.  When its winner is
        among the candidates, only that surface is rebuilt (its agreement
        checked again) and nothing is timed; a winner that is gone, finds no
        target or misses ``min_agree`` now is planned again from scratch.

    Returns ``report`` (a row per candidate: name, ms, img_per_s, agree,
    qualified, note; the dense float32 reference first, for context),
    ``winner``, ``model`` (the winning surface), ``dtype`` and
    ``speedup_vs_dense`` (the winner against the dense candidate, whose BN is
    folded); ``replayed`` when a persisted plan was replayed.
    """
    _check_dtype(dtype)
    logger = get_logger()
    input_shape = tuple(input_shape)
    if time_fn is None:
        from convnet_approximater_tpu_torch.hooks.inference_time_hook import forward_seconds

        def time_fn(name, model, shape, dt):
            return forward_seconds(model, shape, num_iters, warmup)

    ref_model = make()
    device = next(ref_model.parameters()).device
    small = (min(8, input_shape[0]),) + input_shape[1:]
    if calib_batches is None:
        calib_batches = _batches(small, 4, seed + 1000, device, scale=0.8)
    probe_xs = _batches(small, probe_batches, seed + 2000, device)
    ref_top1 = [_top1(ref_model, x) for x in probe_xs]
    if candidates is None:
        candidates = default_candidates(ref_model, dtype=dtype, input_shape=input_shape)

    def build(build_fn):
        return build_fn(make(), torch.Generator().manual_seed(seed), calib_batches)

    if reuse_plan is not None:
        winner = reuse_plan.get("winner")
        build_fn = next((b for n, b in candidates if n == winner), None)
        if build_fn is None:
            logger.warning(f"[plan] persisted winner {winner!r} is not among the candidates; "
                           f"timing them all again")
        else:
            try:
                model = build(build_fn)
            except _NoTargets as e:
                model = None
                logger.warning(f"[plan] persisted winner {winner} found nothing to rewrite "
                               f"({e}); timing the candidates again")
            if model is not None:
                agree = _agreement(model, probe_xs, ref_top1)
                if not winner.startswith("dense/") and agree < min_agree:
                    logger.warning(f"[plan] persisted winner {winner} rebuilt with agreement "
                                   f"{agree:.3f} < min_agree {min_agree}; timing the "
                                   f"candidates again")
                else:
                    if verbose:
                        logger.info(f"[plan] replayed persisted winner {winner} "
                                    f"(agree {agree:.3f}; retime to measure again)")
                    return {"report": reuse_plan["report"], "winner": winner, "model": model,
                            "dtype": reuse_plan.get("dtype", _dtype_name(dtype)),
                            "speedup_vs_dense": reuse_plan.get("speedup_vs_dense"),
                            "replayed": True}

    t_f32 = time_fn("dense/float32", ref_model, input_shape, torch.float32)
    # the dense candidate alone may serve below min_agree, found by name
    dense_name = next((n for n, _ in candidates if n.startswith("dense/")), None)
    report = [{"name": "dense/float32", "ms": t_f32 * 1e3, "img_per_s": input_shape[0] / t_f32,
               "agree": 1.0, "qualified": False, "note": "reference (context only)"}]
    del ref_model
    best = None  # (ms, name, model): only the best qualified surface is kept
    for name, build_fn in candidates:
        try:
            model = build(build_fn)
        except _NoTargets as e:
            report.append({"name": name, "ms": None, "img_per_s": None, "agree": None,
                           "qualified": False, "note": f"skipped: {e}"})
            continue
        agree = _agreement(model, probe_xs, ref_top1)
        qualified = name == dense_name or agree >= min_agree
        t = time_fn(name, model, input_shape, dtype)
        note = "" if qualified else "needs_recovery (below min_agree)"
        report.append({"name": name, "ms": t * 1e3, "img_per_s": input_shape[0] / t,
                       "agree": agree, "qualified": qualified, "note": note})
        if qualified and (best is None or t * 1e3 < best[0]):
            best = (t * 1e3, name, model)
        del model
        if verbose:
            logger.info(f"[plan] {name}: {t * 1e3:.3f} ms | agree {agree:.3f}"
                        + (f" | {note}" if note else ""))

    qualified_rows = [r for r in report if r["qualified"]]
    if not qualified_rows:
        raise ValueError("no candidate qualified (a candidates list without a dense/* "
                         "baseline, and nothing met min_agree): lower min_agree or include "
                         "a dense baseline")
    winner_row = min(qualified_rows, key=lambda r: r["ms"])
    winner = winner_row["name"]
    # the dense candidate, not the reference row of the same name (float32 has
    # both): the baseline at the serving type, its BN folded as every candidate's
    dense_row = next((r for r in report[1:] if r["name"] == dense_name), report[0])
    assert best is not None and best[1] == winner
    if verbose:
        logger.info(f"[plan] winner: {winner} ({dense_row['ms'] / winner_row['ms']:.3f}x vs "
                    f"{dense_name})")
    return {"report": report, "winner": winner, "model": best[2], "dtype": _dtype_name(dtype),
            "speedup_vs_dense": dense_row["ms"] / winner_row["ms"]}


def plan_to_json(plan: Dict) -> Dict:
    """The persistable part of a plan (no model)."""
    return {k: plan[k] for k in ("report", "winner", "dtype", "speedup_vs_dense")}


def recovery_plan(name: str, v3_energy: float = 0.9, dwsep_rank: int = 1):
    """The recovery stages of the candidate surface ``name``, in the order its
    build applies the lossy rewrites: config-expressible dicts ``{"app":
    ..., "filters": ..., "calibration": bool}`` or ``{"structure_pass":
    ...}``, and ``{"qat": True}`` last when the surface quantizes.  Exact
    passes (MSCA-rep, FfnRep, the BN fold) need no recovery.  Each stage is
    one fine-tune run (``plan_serving --emit-recovery`` writes the configs).
    """
    stages = []
    if "trunk+" in name:
        # the shared trunk mask comes first, recovered by the later stages' CE;
        # round_to follows the candidate's pass (ConvNeXt's quad snaps to 128)
        stages.append(dict(structure_pass=dict(
            fn="prune_trunks", keep_ratio=0.5, round_to=128 if "mlpprune" in name else 64)))
    if name.startswith("v3/"):
        stages.append(dict(app=dict(type="LowRankExpV3", energy=v3_energy, data_driven=True),
                           filters=[dict(type="DenseKxKFilter")], calibration=True))
    if name.startswith("tucker/"):
        stages.append(dict(app=dict(type="LowRankExpV4", energy=v3_energy, data_driven=True),
                           filters=[dict(type="DenseKxKFilter")], calibration=True))
    if "attnprune" in name:
        stages.append(dict(app=dict(type="AttnPrune", keep_ratio=0.5), filters=[],
                           calibration=True))
    if "ffnprune/" in name:
        stages.append(dict(app=dict(type="FfnPrune", keep_ratio=0.5, round_to=128),
                           filters=[], calibration=True))
    if "mlpprune/" in name:
        stages.append(dict(app=dict(type="MlpPrune", keep_ratio=0.5, round_to=128),
                           filters=[], calibration=True))
    if "dwsep/" in name:
        stages.append(dict(app=dict(type="DwSepRep", ranks=dwsep_rank),
                           filters=[dict(type="DepthwiseConvFilter")], calibration=False))
    if "chainprune/" in name:
        stages.append(dict(structure_pass=dict(fn="prune_chains", keep_ratio=0.5,
                                               round_to=64)))
    if "int8" in name:
        stages.append(dict(qat=True))
    return stages
