"""Deploy-mode comparison of the original and the compressed model (port of
``convnet_approximater_tpu/runner/class_inference.py``).

:class:`ClassInference` builds the config's model twice from one seed: the
original, and the approximated one in deploy mode (the app's sites as their
bare targets, the config's ``structure_passes`` replayed first, then the
compressed checkpoint loaded strictly).  Each report times the forward
(``hooks.forward_times``: on the card a CUDA graph replayed back to back, with
the median of 10 eager forwards after 3 beside it), counts its MACs and
parameters, and evaluates it when ``eval_cfg`` is given.  Optional reports
follow on the approximated model: ``decomposed`` (every ``LowRankExpConvV1``
split into its separable form), ``never-lose`` (``deploy.never_lose_deploy``;
its table goes to ``work_dir/never_lose_decisions.json``) and ``int8``
(``fold_batchnorm``, then ``quantize_int8`` on eval or synthetic batches).

``dtype="bfloat16"`` serves every report in bf16, as the JAX runner does:
each report times, counts and evaluates a cast copy of the model
(``cast_floating``; the model itself keeps its float32 weights for the
reports after it) and is tagged ``<tag>/bfloat16``; ``never_lose_deploy``
decides at that type; the int8 report casts the folded model before
``quantize_int8`` calibrates it on bf16 batches, as the JAX runner does, and
its int8 modules keep their float32 scales.  ``fold_bn`` is on by default for
a type other than float32.

``pipeline_parallel`` = pp > 1 serves each report as a GPipe pipeline over
the ``(world // pp, pp)`` mesh of the process group (``parallel``; one
process per device, the mesh's ``model`` axis pp ranks long, and a pp that
does not divide the world size raises): ``pipeline_mode="stage"`` pipelines
the blocks inside each stage of a model with a pipeline carrier (MSCAN's
backbone, ConvNeXt; ``models/stage_exec.py``), ``"whole"`` partitions the
whole model into pp stages balanced by MACs (``parallel.build_model_pipeline``)
and logs each stage's share.  A model that cannot pipeline warns and is
served plainly.  A pipelined report is timed by :func:`pipelined_ms`: the
eager forward between barriers, CUDA events, the slowest rank, and no CUDA
graph, since its sends between ranks are not captured.  ``s2d_stem``, a TPU
rewrite the port does not carry, raises ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from convnet_approximater_tpu_torch import deploy
from convnet_approximater_tpu_torch.classification.validate import ValidateHelper
from convnet_approximater_tpu_torch.core import build_app
from convnet_approximater_tpu_torch.filters import build_filter
from convnet_approximater_tpu_torch.hooks.inference_time_hook import forward_times
from convnet_approximater_tpu_torch.hooks.model_analysis import count_macs, count_params
from convnet_approximater_tpu_torch.layers import LowRankExpConvV1
from convnet_approximater_tpu_torch.models import build_model
from convnet_approximater_tpu_torch.models.stage_exec import resolve_pipeline_carrier
from convnet_approximater_tpu_torch.nn import GELU, channels_last, init_weights
from convnet_approximater_tpu_torch.parallel import build_model_pipeline, make_mesh, process_count
from convnet_approximater_tpu_torch.utils import get_cfg, get_logger
from convnet_approximater_tpu_torch.utils.dtype import (cast_floating, dtype_name, dtype_of,
                                                        serving_dtype)

from .base import BaseRunner
from .runner import read_checkpoint, structure_pass


def pipeline_mesh(pp: int):
    """The ``(world // pp, pp)`` mesh of the process group."""
    n = process_count()
    if n % pp:
        raise ValueError(f"pipeline_parallel={pp} doesn't divide {n} processes")
    return make_mesh(data=n // pp, model=pp)


def enable_stage_pipeline(model: nn.Module, mesh, num_microbatches: int = None) -> bool:
    """Pipeline the stages of ``model``'s carrier over ``mesh``'s model axis;
    warn and return False where it has none."""
    carrier = resolve_pipeline_carrier(model)
    if carrier is None:
        get_logger().warning(f"pipelining over {mesh.size(1)} ranks: {type(model).__name__} "
                             f"has no pipeline-capable backbone; served plainly")
        return False
    carrier.enable_pipeline(mesh, num_microbatches=num_microbatches)
    return True


@torch.no_grad()
def pipelined_ms(forward: Callable, x: torch.Tensor, num_iters: int = 10,
                 warmup: int = 3) -> float:
    """Median ms of ``forward(x)``, a forward across the process group, over
    ``num_iters`` after ``warmup``: each forward starts after a barrier and is
    timed by CUDA events on the card (the host clock on the CPU); each
    iteration counts the slowest rank's time."""
    times = []
    for i in range(warmup + num_iters):
        dist.barrier()
        if x.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            forward(x)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            forward(x)
            ms = (time.perf_counter() - t0) * 1e3
        if i >= warmup:
            times.append(ms)
    slowest = torch.tensor(times, dtype=torch.float64, device=x.device)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    return float(np.median(slowest.cpu().numpy()))


class ClassInference(BaseRunner):
    """``exact_gelu`` (default True) serves every GELU in its erf form, as
    checkpoints fine-tuned in torch were trained; the JAX package's default
    form is tanh.  ``fold_bn`` folds BatchNorm (and runs the 1x1 convs as
    matmuls) before each report; off by default in float32, as in the JAX
    package, on for any other ``dtype``.  ``reports`` holds each report's
    ``ms``, ``eager_ms``, ``macs``, ``params`` and ``eval`` (None without
    ``eval_cfg``) by tag."""

    def __init__(self, checkpoint: str, batch_size: int = 16, input_size=(224, 224, 3),
                 do_decomp: bool = False, eval_cfg=None, device="cuda",
                 generator: Optional[torch.Generator] = None, exact_gelu: bool = True,
                 dtype: str = "float32", fold_bn=None, never_lose: bool = False,
                 s2d_stem: bool = False, pipeline_parallel: int = 1,
                 pipeline_mode: str = "stage", quantize: Optional[str] = None):
        if pipeline_mode not in ("stage", "whole"):
            raise ValueError(f"pipeline_mode={pipeline_mode!r}")
        if s2d_stem:
            raise NotImplementedError("ClassInference s2d_stem=True: the S2D stem is a TPU "
                                      "rewrite the port does not carry (ROADMAP.md, 'Code the "
                                      "port does not carry')")
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize={quantize!r} (expected None or 'int8')")
        cfg = get_cfg()
        self.cfg = cfg
        self.checkpoint = checkpoint
        self.batch_size = batch_size
        self.input_size = tuple(input_size)
        self.do_decomp = do_decomp
        self.eval_cfg = dict(eval_cfg or {})
        self.device = torch.device(device)
        self.seed = generator.initial_seed() if generator is not None else (cfg.seed or 0)
        self.exact_gelu = exact_gelu
        self.dtype = dtype_of(str(dtype).replace("torch.", ""))
        self.fold_bn = self.dtype != torch.float32 if fold_bn is None else bool(fold_bn)
        self.never_lose = never_lose
        self.quantize = quantize
        self.pipeline_parallel = int(pipeline_parallel)
        self.pipeline_mode = pipeline_mode
        self.mesh = pipeline_mesh(self.pipeline_parallel) if self.pipeline_parallel > 1 else None
        self.passes = [structure_pass(p) for p in cfg.structure_passes or []]
        self.app = build_app(cfg.app, deploy=True)
        self.ori_model = build_model(cfg.model)
        self.new_model = build_model(cfg.model)
        self.reports: Dict[str, dict] = {}

    # -- building ----------------------------------------------------------
    def _prepare(self, model: nn.Module) -> nn.Module:
        """Weights from the seed (both models draw the same), ``init_cfg``,
        the device, ``channels_last``, eval mode and the GELU form."""
        init_weights(model, torch.Generator().manual_seed(self.seed))
        model.load_init_cfg()
        channels_last(model.to(self.device)).eval()
        if self.exact_gelu:
            for m in model.modules():
                if isinstance(m, GELU):
                    m.approximate = False
        return model

    def build_approximated(self) -> nn.Module:
        """The approximated model in deploy mode, the checkpoint loaded."""
        model = self._prepare(self.new_model)
        for fn, kwargs in self.passes:
            fn(model, **kwargs)
        # registered after the passes, with fresh filters (IndicesFilter counts)
        model.register_switchable(self.app.src_type,
                                  [build_filter(f) for f in self.cfg.filters or []])
        gen = torch.Generator().manual_seed(self.seed)
        for idx in range(model.length_switchable):
            model.set_switchable_module(idx, self.app.initialize(
                model.get_switchable_module(idx), gen).eval())
        channels_last(model)
        get_logger().info(f"loading checkpoint from {self.checkpoint}")
        model.load_state_dict(read_checkpoint(self.checkpoint, self.device))
        return model

    def _calib_batches(self, num_batches: int = 4, batch: int = 8) -> List[torch.Tensor]:
        """int8 calibration inputs: eval batches when ``eval_cfg`` names a
        dataset, else normal batches (scale 0.8) from a generator of the seed."""
        H, W, C = self.input_size
        if self.eval_cfg.get("dataset"):
            from convnet_approximater_tpu_torch.data import Loader, build_dataset

            ds = build_dataset(dict(self.eval_cfg["dataset"]),
                               split=self.eval_cfg.get("split", "validation"))
            out = []
            for i, (x, _) in enumerate(Loader(ds, batch, shuffle=False, image_size=(H, W),
                                              device=self.device, dtype=self.dtype)):
                if i >= num_batches:
                    break
                out.append(x)
            if out:
                return out
        gen = torch.Generator().manual_seed(self.seed + 1000)
        return [(torch.randn(batch, C, H, W, generator=gen) * 0.8).to(
            self.device, self.dtype).contiguous(memory_format=torch.channels_last)
            for _ in range(num_batches)]

    # -- reports -----------------------------------------------------------
    def _report(self, tag: str, model: nn.Module):
        """Time, count and evaluate ``model`` at the serving type: a cast copy
        of a model of another type (the int8 surface is cast before it is
        quantized, so it serves as it is)."""
        logger = get_logger()
        if self.fold_bn:
            deploy.fold_batchnorm(model)
            deploy.enable_pw_matmul(model)
        if self.dtype != torch.float32:
            if serving_dtype(model) != self.dtype:
                model = cast_floating(copy.deepcopy(model), self.dtype)
            tag = f"{tag}/{dtype_name(self.dtype)}"
        shape = (self.batch_size,) + self.input_size
        B, H, W, C = shape
        x = torch.zeros(B, C, H, W, device=self.device, dtype=self.dtype).contiguous(
            memory_format=torch.channels_last)
        macs, params = count_macs(model.eval(), x), count_params(model)
        forward = self._pipelined(tag, model, shape) if self.mesh is not None else None
        if forward is None:
            timing = forward_times(model, shape, num_iters=10, warmup=3, dtype=self.dtype)
            ms, eager_ms = timing["ms"], timing["eager_median_ms"]
            logger.info(f"[{tag}] fwd median {ms:.3f} ms (eager median {eager_ms:.3f} ms) | "
                        f"MACs {macs / 1e6:.2f} M | params {params / 1e6:.2f} M")
        else:
            gen = torch.Generator().manual_seed(self.seed)
            ms = eager_ms = pipelined_ms(forward, torch.randn(B, C, H, W, generator=gen).to(
                self.device, self.dtype).contiguous(memory_format=torch.channels_last))
            logger.info(f"[{tag}] {self.pipeline_parallel}-stage {self.pipeline_mode} pipeline "
                        f"fwd median {ms:.3f} ms (eager, the slowest of {process_count()} "
                        f"ranks; no CUDA graph) | MACs {macs / 1e6:.2f} M | "
                        f"params {params / 1e6:.2f} M")
            if self.pipeline_mode == "whole":
                forward.close()  # the plain model validates, as in the JAX runner
        result = None
        if self.eval_cfg:
            result = ValidateHelper(model, self.eval_cfg, device=self.device).validate()
            logger.info(f"[{tag}] eval: {result}")
        if forward is not None and self.pipeline_mode == "stage":
            resolve_pipeline_carrier(model).enable_pipeline(None)
        self.reports[tag] = dict(ms=ms, eager_ms=eager_ms, macs=macs, params=params,
                                 eval=result)

    def _pipelined(self, tag: str, model: nn.Module, shape) -> Optional[Callable]:
        """``model``'s forward pipelined in ``pipeline_mode``, or None where it
        cannot be (warned)."""
        if self.pipeline_mode == "stage":
            return model if enable_stage_pipeline(model, self.mesh) else None
        if not hasattr(model, "pipeline_units"):
            get_logger().warning(f"pipeline_mode='whole': {type(model).__name__} has no "
                                 f"pipeline_units(); served plainly")
            return None
        forward, report = build_model_pipeline(model, shape, self.mesh, dtype=self.dtype)
        for r in report:
            get_logger().info(f"[{tag}] pp stage {r['stage']}: {r['share']:.0%} MACs, "
                              f"{len(r['units'])} units")
        return forward

    def run(self) -> Dict[str, dict]:
        logger = get_logger()
        self._report("original", self._prepare(self.ori_model))

        model = self.build_approximated()
        self._report("approximated", model)

        if self.do_decomp:
            for mod in model.switchable_modules():
                if isinstance(mod, LowRankExpConvV1):
                    mod.decomp()
            self._report("decomposed", model)

        if self.never_lose:
            res = deploy.never_lose_deploy(model, (self.batch_size,) + self.input_size,
                                           dtype=self.dtype)
            for row in res["layers"]:
                logger.info(f"[arbiter] {row['name']}: {row['kept']}")
            path = os.path.join(self.cfg.work_dir or ".", "never_lose_decisions.json")
            with open(path, "w") as f:
                json.dump(res, f, indent=2, default=float)
            logger.info(f"arbiter decisions -> {path}")
            self._report("never-lose", model)

        if self.quantize == "int8":
            deploy.fold_batchnorm(model)
            cast_floating(model, self.dtype)  # the int8 surface quantizes the served weights
            nq = deploy.quantize_int8(model, self._calib_batches())
            logger.info(f"quantize_int8: {nq} convs quantized")
            self._report("int8", model)
        return self.reports
