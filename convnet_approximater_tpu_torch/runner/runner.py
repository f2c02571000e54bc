"""The 4-phase approximation pipeline: Register -> Initialize -> Optimize ->
PostProcess, with hook dispatch between phases (port of
``convnet_approximater_tpu/runner/runner.py``).

The runner owns the model, its device and the generator its random weights
come from.  No phase trains, so the model stays in eval mode throughout.
``cfg.structure_passes`` (deploy rewrites such as ``fold_batchnorm`` or
``prune_trunks``, by name) run after the weights are drawn or loaded and before
the app's sites are initialized; the model as it stood before them is kept as
``model_before_passes`` (an asym fine-tune's teacher), and a checkpoint of
the run loads back through the same config with :meth:`Runner.restore`.

``deploy=True`` builds the app's sites as bare targets (no ``Substitution``)
and loads ``cfg.checkpoint`` into them after Initialize: a compressed model
straight into its served form, with no solve.  ``skip_optim`` and
``skip_post`` skip the Optimize and PostProcess phases; deploy mode needs both,
since its sites hold nothing to solve or unwrap.  The hooks run at the same
stages either way.
"""

from __future__ import annotations

import copy
import inspect
import os
from typing import Callable, List, Optional, Tuple

import torch

from convnet_approximater_tpu_torch import deploy
from convnet_approximater_tpu_torch.core import build_app
from convnet_approximater_tpu_torch.filters import build_filter
from convnet_approximater_tpu_torch.hooks import Hook, build_hook
from convnet_approximater_tpu_torch.models import build_model
from convnet_approximater_tpu_torch.convert import params_from_jax
from convnet_approximater_tpu_torch.nn import channels_last, init_weights
from convnet_approximater_tpu_torch.parallel.distributed import is_main_process
from convnet_approximater_tpu_torch.utils import get_cfg, get_logger, load_flat, print_cfg, save_cfg

from .base import BaseRunner


def structure_pass(cfg) -> Tuple[Callable, dict]:
    """``(function of deploy.py, keyword arguments)`` of one ``structure_passes`` entry."""
    kwargs = dict(cfg)
    name = kwargs.pop("fn")
    fn = getattr(deploy, name, None)
    if not (inspect.isfunction(fn) and fn.__module__ == deploy.__name__) or name.startswith("_"):
        raise ValueError(f"structure_passes: deploy.py has no pass {name!r}")
    return fn, kwargs


def read_checkpoint(path: str, device="cpu") -> dict:
    """The port's ``state_dict`` of a checkpoint: the Runner's ``.pt``, or a flat
    ``.npz`` (the fine-tune's, or the JAX package's ``.ckpt.npz``), whose
    ``params``/``state`` leaves it converts."""
    if path.endswith(".pt"):
        return torch.load(path, map_location=device)
    return params_from_jax({k: v for k, v in load_flat(path).items()
                            if k.split("/", 1)[0] in ("params", "state")})


def _overrides(method: str, base: type, obj) -> bool:
    return getattr(type(obj), method) is not getattr(base, method)


class Runner(BaseRunner):
    def __init__(self, device="cuda", generator: Optional[torch.Generator] = None,
                 deploy: bool = False, skip_optim: bool = False, skip_post: bool = False):
        cfg = get_cfg()
        if deploy and not (skip_optim and skip_post):
            raise ValueError("Runner(deploy=True) needs skip_optim and skip_post: a deploy "
                             "site is the bare target, with nothing to solve or unwrap")
        if deploy and not cfg.checkpoint:
            raise ValueError("Runner(deploy=True) loads cfg.checkpoint, and the config has none")
        self.deploy = deploy
        self.skip_optim = skip_optim
        self.skip_post = skip_post
        self.passes = [structure_pass(p) for p in cfg.structure_passes or []]
        self.cfg = cfg
        self.device = torch.device(device)
        self.generator = (generator if generator is not None
                          else torch.Generator().manual_seed(cfg.seed or 0))
        self.model = build_model(cfg.model)
        self.model_before_passes = None
        self.app = build_app(cfg.app, deploy=deploy)
        self.filters = [build_filter(f_cfg) for f_cfg in cfg.filters or []]
        self.hooks: List[Hook] = []
        self.output_path = None
        if is_main_process() and cfg.work_dir:  # only the main process writes
            os.makedirs(cfg.work_dir, exist_ok=True)
            print_cfg()
            save_cfg(os.path.join(cfg.work_dir, "cfg.json"))
            name = cfg.config_name or cfg.name or "model"
            self.output_path = os.path.join(cfg.work_dir, name + ".pt")
        for h_cfg in cfg.hooks or []:
            self.register_hook(h_cfg)
        if self.hooks:
            get_logger().info(self.hook_info())

    # -- phases ----------------------------------------------------------
    def run(self):
        logger = get_logger()
        model, app = self.model, self.app
        self.call_hook("before_run")

        logger.info("Register...")
        model.register_switchable(app.src_type, self.filters, verbose=True)
        logger.info(f"{model.length_switchable} switchable submodules: {model.switchable_names}")
        self.call_hook("after_register")

        logger.info("Initialize...")
        self.init_model()
        for idx in range(model.length_switchable):
            sub = app.initialize(model.get_switchable_module(idx), self.generator)
            model.set_switchable_module(idx, sub.eval())
        self.call_hook("after_initialize")

        if self.deploy:
            channels_last(model)
            self.load_checkpoint(self.cfg.checkpoint)

        if not self.skip_optim:
            logger.info("Optimize...")
            for idx in range(model.length_switchable):
                app.optimize(model.get_switchable_module(idx))
        self.call_hook("after_optimize")

        if not self.skip_post:
            logger.info("PostProcess...")
            for idx in range(model.length_switchable):
                model.set_switchable_module(idx, app.postprocess(model.get_switchable_module(idx)))
        channels_last(model)

        if self.output_path:
            torch.save(model.state_dict(), self.output_path)
            logger.info(f"saved model to {self.output_path}")
        self.call_hook("after_run")

    def init_model(self):
        """Draw the weights, load ``init_cfg``, move the model to the device in
        ``channels_last`` and eval mode, and run the structure passes.  A pass
        may change the structure under the registered names, and
        ``prune_width``'s app loop registers its own sites: the app's sites are
        registered again after them, with fresh filters (IndicesFilter counts)."""
        model = self.model
        init_weights(model, self.generator)
        model.load_init_cfg()
        channels_last(model.to(self.device)).eval()
        if self.passes:
            self.model_before_passes = copy.deepcopy(model)
            self.apply_structure_passes()
            model.register_switchable(self.app.src_type,
                                      [build_filter(f) for f in self.cfg.filters or []])

    def apply_structure_passes(self):
        """``cfg.structure_passes``, in order: deploy rewrites by name (for
        example ``dict(fn="fold_batchnorm")``), each called on the model with
        the dict's other keys."""
        for fn, kwargs in self.passes:
            n = fn(self.model, **kwargs)
            get_logger().info(f"structure pass {fn.__name__}: {n} sites")

    def restore(self, path: str):
        """Load a checkpoint of a run of this config into a fresh model: the
        Runner's ``.pt`` state_dict, or a flat ``.npz`` (the fine-tune's, or
        the JAX package's).  The weights are drawn and the structure passes
        replayed first, so that the shapes match; a pass's selection need not
        replay, the load overwrites the values.  The load is strict: a key or
        shape that differs raises."""
        self.init_model()
        self.load_checkpoint(path)

    def load_checkpoint(self, path: str):
        """Load ``path`` (a ``.pt`` state_dict, or a flat ``.npz`` of either
        package) into the model as it stands, strictly."""
        get_logger().info(f"loading checkpoint from {path}")
        self.model.load_state_dict(read_checkpoint(path, self.device))

    # -- hook machinery --------------------------------------------------
    def register_hook(self, hook_cfg):
        hook = build_hook(hook_cfg, runner=self)
        idx = 0
        for h in self.hooks:
            if hook.priority < h.priority:
                break
            idx += 1
        self.hooks.insert(idx, hook)

    def call_hook(self, stage: str):
        for h in self.hooks:
            getattr(h, stage)()

    def hook_info(self) -> str:
        lines = ["\n"]
        for stage in Hook.stages:
            lines.append(f"Stage {stage}:")
            lines.append(f"{'Name':^24}|{'Prio':^8}")
            lines.append("-" * 33)
            for h in self.hooks:
                if _overrides(stage, Hook, h):
                    lines.append(f"{h.name:^24}|{h.priority:^8}")
            lines.append("-" * 33)
        return "\n".join(lines)
