"""Deploy-mode comparison of the original and the compressed model (port of
``convnet_approximater_tpu/runner/class_inference.py``).

:class:`ClassInference` builds the config's model twice from one seed: the
original, and the approximated one in deploy mode (the app's sites as their
bare targets, the config's ``structure_passes`` replayed first, then the
compressed checkpoint loaded strictly).  Each report times the forward (the
median of 10 CUDA-event-timed forwards after 3), counts its MACs and
parameters, and evaluates it when ``eval_cfg`` is given.  Optional reports
follow on the approximated model: ``decomposed`` (every ``LowRankExpConvV1``
split into its separable form), ``never-lose`` (``deploy.never_lose_deploy``;
its table goes to ``work_dir/never_lose_decisions.json``) and ``int8``
(``fold_batchnorm``, then ``quantize_int8`` on eval or synthetic batches).

The port serves float32 on one card: ``dtype`` other than float32 (ROADMAP.md
queue 1, item 7) and ``pipeline_parallel`` > 1 (item 12) raise
``NotImplementedError``, and so does ``s2d_stem``, a TPU rewrite the port does
not carry.
"""

from __future__ import annotations

import json
import os
from abc import ABC, abstractmethod
from typing import Dict, List, Optional

import torch
from torch import nn

from convnet_approximater_tpu_torch import deploy
from convnet_approximater_tpu_torch.classification.validate import ValidateHelper
from convnet_approximater_tpu_torch.core import build_app
from convnet_approximater_tpu_torch.filters import build_filter
from convnet_approximater_tpu_torch.hooks.inference_time_hook import forward_seconds
from convnet_approximater_tpu_torch.hooks.model_analysis import count_macs, count_params
from convnet_approximater_tpu_torch.layers import LowRankExpConvV1
from convnet_approximater_tpu_torch.models import build_model
from convnet_approximater_tpu_torch.nn import GELU, channels_last, init_weights
from convnet_approximater_tpu_torch.utils import get_cfg, get_logger

from .runner import read_checkpoint, structure_pass


class BaseRunner(ABC):
    @abstractmethod
    def run(self):
        ...


class ClassInference(BaseRunner):
    """``exact_gelu`` (default True) serves every GELU in its erf form, as
    checkpoints fine-tuned in torch were trained; the JAX package's default
    form is tanh.  ``fold_bn`` folds BatchNorm (and runs the 1x1 convs as
    matmuls) before each report; off by default in float32, as in the JAX
    package.  ``reports`` holds each report's ``ms``, ``macs``, ``params`` and
    ``eval`` (None without ``eval_cfg``) by tag."""

    def __init__(self, checkpoint: str, batch_size: int = 16, input_size=(224, 224, 3),
                 do_decomp: bool = False, eval_cfg=None, device="cuda",
                 generator: Optional[torch.Generator] = None, exact_gelu: bool = True,
                 dtype: str = "float32", fold_bn=None, never_lose: bool = False,
                 s2d_stem: bool = False, pipeline_parallel: int = 1,
                 quantize: Optional[str] = None):
        if str(dtype).replace("torch.", "") != "float32":
            raise NotImplementedError(f"ClassInference dtype={dtype!r}: the port serves float32 "
                                      f"only (bf16 end to end is ROADMAP.md queue 1, item 7)")
        if int(pipeline_parallel) > 1:
            raise NotImplementedError(f"ClassInference pipeline_parallel={pipeline_parallel}: "
                                      f"pipelining waits for a multi-GPU host (ROADMAP.md "
                                      f"queue 1, item 12)")
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
        self.fold_bn = bool(fold_bn)
        self.never_lose = never_lose
        self.quantize = quantize
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
                                              device=self.device)):
                if i >= num_batches:
                    break
                out.append(x)
            if out:
                return out
        gen = torch.Generator().manual_seed(self.seed + 1000)
        return [(torch.randn(batch, C, H, W, generator=gen) * 0.8).to(self.device).contiguous(
            memory_format=torch.channels_last) for _ in range(num_batches)]

    # -- reports -----------------------------------------------------------
    def _report(self, tag: str, model: nn.Module):
        logger = get_logger()
        if self.fold_bn:
            deploy.fold_batchnorm(model)
            deploy.enable_pw_matmul(model)
        shape = (self.batch_size,) + self.input_size
        ms = forward_seconds(model, shape, num_iters=10, warmup=3) * 1e3
        B, H, W, C = shape
        x = torch.zeros(B, C, H, W, device=self.device).contiguous(
            memory_format=torch.channels_last)
        macs, params = count_macs(model.eval(), x), count_params(model)
        logger.info(f"[{tag}] fwd median {ms:.3f} ms | MACs {macs / 1e6:.2f} M | "
                    f"params {params / 1e6:.2f} M")
        result = None
        if self.eval_cfg:
            result = ValidateHelper(model, self.eval_cfg, device=self.device).validate()
            logger.info(f"[{tag}] eval: {result}")
        self.reports[tag] = dict(ms=ms, macs=macs, params=params, eval=result)

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
            res = deploy.never_lose_deploy(model, (self.batch_size,) + self.input_size)
            for row in res["layers"]:
                logger.info(f"[arbiter] {row['name']}: {row['kept']}")
            path = os.path.join(self.cfg.work_dir or ".", "never_lose_decisions.json")
            with open(path, "w") as f:
                json.dump(res, f, indent=2, default=float)
            logger.info(f"arbiter decisions -> {path}")
            self._report("never-lose", model)

        if self.quantize == "int8":
            deploy.fold_batchnorm(model)
            nq = deploy.quantize_int8(model, self._calib_batches())
            logger.info(f"quantize_int8: {nq} convs quantized")
            self._report("int8", model)
        return self.reports
