"""Classification training from scratch (port of
``convnet_approximater_tpu/classification/train.py``).

:class:`TrainHelper` trains a model in place on ``device`` (the card unless
the caller asks for the CPU) with cross-entropy, to produce the baselines the
pipeline compresses: the ``Loader`` with ``drop_last`` and the train
augmentation ``aug`` (``rand_aug`` included); label smoothing; Mixup/CutMix
after the amp cast (``data/mixup.py``, its draws from a CPU generator seeded
from the run's seed and step); :class:`~convnet_approximater_tpu_torch.hooks.finetune.MaskedOptimizer`
over every parameter, with gradient clipping, the schedule and warm-up, and
``grad_accum`` as ``optax.MultiSteps`` (k micro-batches averaged into one
update; the schedule counts updates); an EMA of every floating parameter and
buffer updated on every micro-step (:func:`ema_update`), whose weights the
validation and the checkpoint metric use; best-k checkpoints, ``summary.csv``
and ``max_steps_per_epoch``/``max_eval_batches``; ``resume`` from a checkpoint
of either package (params, state, ``ema``, ``opt`` and ``meta.epoch``); a
SIGTERM stops at the next step and saves the full train state.

``amp`` computes in bf16 over float32 masters, as the JAX step does: the
images and bf16 casts of the floating parameters go through the forward
(``torch.func.functional_call``, so the gradients reach the float32 masters
through the casts), the logits come back to float32 before the loss, and the
masters, their gradients, the optimizer state and BatchNorm's running
statistics stay float32, with no loss scaling.

Drop masks come from a device generator seeded from the run's seed and the
step (``layers/drop.py::drop_generator``).  The epoch checkpoints carry the
optimizer state, so a resume continues the run exactly; the JAX helper's
carry none (only its preemption save does).  ``ckpt_backend="sharded"``
saves the same train state as asynchronous ``torch.distributed.checkpoint``
directories (``hooks/finetune.py::CheckpointSaver``), which ``resume`` reads
too.

``use_mesh`` (the default) in a process group of more than one rank trains
data-parallel, as the JAX helper's step over its mesh's data axis
(``parallel/data_parallel.py``): every rank starts from the first rank's
weights, loads its rows of each global batch (augmentation drawn per global
batch), mixes them with partners from the gathered global batch (one draw
per global batch), runs BatchNorm and the drop masks over the global batch,
and averages the gradients over the ranks once per update, so the weights,
the optimizer state and the EMA stay what one process computes; the logged
loss and the validation are the global batch's, and the ranks decide a
preemption stop together.

``pipeline_parallel=pp`` > 1 (with ``pipeline_microbatches=M``, default
``pp``) trains through the GPipe pipeline on a ``(world / pp, pp)`` mesh, as
the JAX helper does (``models/stage_exec.py``, ``parallel/pp.py``): every
rank starts from the first rank's weights (and a ``resume`` loads) before
the blocks other pipe ranks own are released; the optimizer, its clipping,
the EMA (pipelined too) and the checkpoints hold the rank's own blocks and
the replicated parts, whose gradients come from pipe rank 0; ``norm``
clipping takes the global norm over the pipe group; an npz checkpoint holds
the whole model (each block from its owner), a sharded one is written by
each pipe rank for the blocks it owns; at the end every rank gets each
block's trained weights from its owner.  A model without a pipeline-capable
stage engine trains unpipelined (with a warning), as in JAX.

``model_parallel=mp`` > 1 (with ``tp_rules``, ``parallel/tp.py``) trains
tensor-parallel on a ``(world / mp, mp)`` mesh, as the JAX helper's
``shard_variables`` does: every rank starts from the first rank's weights
(and a ``resume`` loads the whole model) before the model and the EMA keep
their shards (``parallel.tp.shard_module``); the optimizer's state is the
rank's shards and the replicated parameters, whose gradients come from model
rank 0, and ``norm`` clipping counts each shard's squares over the model
group; both checkpoint backends write the whole model and optimizer state,
gathered over the model group; at the end every rank gathers the whole
trained model back.  One process (or ``use_mesh`` off) trains unsharded,
with a warning.  ``model_parallel`` and ``pipeline_parallel`` both above 1
raise ``ValueError``: they share the mesh's model axis.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from convnet_approximater_tpu_torch.convert import load_jax_flat, params_to_jax, variables_of
from convnet_approximater_tpu_torch.data import Loader, Synthetic, build_dataset
from convnet_approximater_tpu_torch.data.mixup import apply_mix, draw_mix
from convnet_approximater_tpu_torch.layers import drop_generator
from convnet_approximater_tpu_torch.nn import DataShard, channels_last, sharded_batch
from convnet_approximater_tpu_torch.models.stage_exec import (block_names, gather_from_owners,
                                                              microbatch_split, owner_of,
                                                              resolve_pipeline_carrier)
from convnet_approximater_tpu_torch.parallel.data_parallel import (pipe_axis, replicate_from_root,
                                                                   sum_over, training_axis,
                                                                   training_mesh, world_axis)
from convnet_approximater_tpu_torch.parallel.mesh import MODEL_AXIS, axis_ranks
from convnet_approximater_tpu_torch.parallel.spatial import is_spatial, refuse_spatial
from convnet_approximater_tpu_torch.parallel.tp import (gather_tensors, shard_module, summary,
                                                        tp_plan, unshard_module)
from convnet_approximater_tpu_torch.utils import get_logger, get_rank, load_flat, unflatten_tree
from convnet_approximater_tpu_torch.utils.config import Config
from convnet_approximater_tpu_torch.utils.dtype import cast_params
from convnet_approximater_tpu_torch.utils.preempt import Preempted, PreemptionGuard

from .validate import AverageMeter, eval_batch

_default_train_cfg = dict(
    batch_size=128,
    image_size=(32, 32),
    mean=(0.4914, 0.4822, 0.4465),
    std=(0.2470, 0.2435, 0.2616),
    dataset=None,  # DATASET registry cfg; None -> Synthetic(512) / Synthetic(128)
    num_classes=10,
    epochs=10,
    opt="adamw",
    lr=1e-3,
    weight_decay=0.05,
    momentum=0.9,
    eps=1e-8,
    sched="cosine",
    min_lr=1e-6,
    warmup_epochs=0,
    decay_rate=0.1,
    label_smoothing=0.0,
    aug=None,  # train-loader augmentation (data/loader.py::augment_batch)
    # in-step Mixup/CutMix: Beta(alpha, alpha) lambda per step, switch_prob picks
    # CutMix over mixup when both alphas are on; 0.0/0.0 = off (nothing drawn)
    mixup=0.0,
    cutmix=0.0,
    mixup_switch_prob=0.5,
    # gradient clipping: max global norm ("norm"), per element ("value") or
    # adaptive ("agc"); 0 = off
    clip_grad=0.0,
    clip_mode="norm",
    log_interval=50,
    eval_metric="top1",
    checkpoint_hist=3,
    use_mesh=True,
    model_parallel=1,
    tp_rules=None,
    pipeline_parallel=1,
    pipeline_microbatches=None,
    max_steps_per_epoch=None,
    max_eval_batches=None,
    amp=False,  # bf16 compute over float32 masters
    # model EMA (timm ModelEmaV2): decay > 0 keeps an exponential moving average
    # of every floating parameter and buffer, updated every micro-step; the
    # validation and the checkpoint metric use the EMA weights
    ema_decay=0.0,
    # gradient accumulation (optax.MultiSteps): k micro-batches averaged into one update
    grad_accum=1,
    resume="",  # checkpoint path: restores weights (+ema/opt if present) + epoch
    ckpt_backend="npz",
    work_dir="work_dirs/train",
    seed=0,
)

MIX_SALT = 0x6d69  # the mixup draws' stream beside the drop masks' (the JAX step's fold_in)


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float):
    """timm ``ModelEmaV2._update``: every floating parameter and buffer of
    ``ema`` becomes ``e * decay + n * (1 - decay)`` (in float32, as the JAX
    ``ema_update`` computes it), every other one (a counter) ``n``."""
    d = np.float32(decay)
    w = float(np.float32(1.0) - d)
    new = model.state_dict(keep_vars=True)
    for name, e in ema.state_dict(keep_vars=True).items():
        if e.is_meta:  # a block another pipe rank owns
            continue
        n = new[name].detach()
        if e.is_floating_point():
            e.mul_(float(d)).add_(n.to(e.dtype) * w)
        else:
            e.copy_(n)


def mix_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s Mixup/CutMix draws in a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step, MIX_SALT]).generate_state(1, np.uint64)[0])


class TrainHelper:
    def __init__(self, model: nn.Module, train_cfg=None, device="cuda"):
        self.cfg = Config()
        self.cfg.update(_default_train_cfg)
        self.cfg.update(train_cfg or {})
        cfg = self.cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TrainHelper device {device}: no CUDA device is available "
                               f"(pass device='cpu' to train on the CPU)")
        if int(cfg.model_parallel or 1) > 1 and int(cfg.pipeline_parallel or 1) > 1:
            raise ValueError("model_parallel and pipeline_parallel both >1: they share the "
                             "mesh's model axis")
        if is_spatial(model):
            raise refuse_spatial("TrainHelper: training under spatial sharding")
        self.model = channels_last(model.to(self.device))
        self.shard: Optional[DataShard] = None  # the data axis, across processes
        self.carriers = []  # the stage engines of the model and the EMA, while pipelined
        self.tp = None  # the tensor-parallel plan of the model, while sharded
        self._stop_axis: Optional[DataShard] = None  # the ranks that decide a stop together
        self.ema: Optional[nn.Module] = None
        self.optimizer = None
        self.num_classes = cfg.num_classes
        self._guard = None
        self._best = (None, None)

    # -- the step --------------------------------------------------------
    def targets(self, labels: torch.Tensor) -> torch.Tensor:
        """One-hot float32 targets, smoothed by ``label_smoothing``."""
        one_hot = F.one_hot(labels, self.num_classes).float()
        s = float(self.cfg.label_smoothing or 0.0)
        if s > 0:
            one_hot = one_hot * (1 - s) + s / self.num_classes
        return one_hot

    def loss(self, images, labels, mix=None):
        """The training loss of a batch, with autograd (the JAX step's
        ``loss_fn``): under amp the bf16 cast, then ``mix`` (a
        :class:`~convnet_approximater_tpu_torch.data.mixup.MixDraw`, or None)
        applied to the images and targets, the forward in training mode, the
        soft-target cross-entropy in float32."""
        model = self.model
        model.train()
        if self.cfg.amp:
            images = images.to(torch.bfloat16)
        images, target = apply_mix(mix, images, self.targets(labels), self.shard)
        if self.cfg.amp:
            logits = torch.func.functional_call(model, cast_params(model), (images,))
        else:
            logits = model(images)
        logits = logits.float()
        return -(F.log_softmax(logits, dim=-1) * target).sum(-1).mean()

    def mix_draw(self, step: int, images):
        """Step ``step``'s Mixup/CutMix draws for the global batch, or None
        when both are off."""
        cfg = self.cfg
        mixup_a, cutmix_a = float(cfg.mixup or 0.0), float(cfg.cutmix or 0.0)
        if mixup_a <= 0 and cutmix_a <= 0:
            return None
        b, _, h, w = images.shape
        b *= self.shard.count if self.shard is not None else 1
        gen = torch.Generator().manual_seed(mix_seed(int(cfg.seed), step))
        return draw_mix(gen, b, h, w, mixup_a, cutmix_a, float(cfg.mixup_switch_prob or 0.5))

    def train_step(self, images, labels, step: int):
        """One micro-step: the loss, its backward, the optimizer (which updates
        on every ``grad_accum``-th call) and the EMA; the loss of this rank's
        rows, detached."""
        self.optimizer.zero_grad()
        with sharded_batch(self.shard):
            loss = self.loss(images, labels, self.mix_draw(step, images))
            loss.backward()
        self.optimizer.step(self._all)
        self.optimizer.zero_grad()
        if self.ema is not None:
            ema_update(self.ema, self.model, float(self.cfg.ema_decay))
        return loss.detach()

    # -- the run ---------------------------------------------------------
    def train(self) -> dict:
        from convnet_approximater_tpu_torch.hooks.finetune import (CheckpointSaver,
                                                                   make_optimizer)

        logger = get_logger()
        cfg = self.cfg
        model = self.model
        pp = int(cfg.pipeline_parallel or 1)
        mp = int(cfg.model_parallel or 1)
        # (both above 1 raise in __init__: they share the mesh's model axis)
        mesh = (training_mesh(cfg.use_mesh, mp, "model_parallel") if mp > 1
                else training_mesh(cfg.use_mesh, pp) if pp > 1 else None)
        if max(pp, mp) > 1 and mesh is None:
            logger.warning(("model_parallel" if mp > 1 else "pipeline_parallel")
                           + f"={max(pp, mp)}: one process (or use_mesh off): trained "
                           + ("unsharded" if mp > 1 else "unpipelined"))
        self.shard = shard = training_axis(cfg.use_mesh, mesh)
        self._stop_axis = world_axis() if mesh is not None else shard
        if mesh is not None and pp > 1:
            microbatch_split(shard.count if shard is not None else 1,
                             int(cfg.pipeline_microbatches or pp))
        replicate_from_root(model, shard, mesh)
        if shard is not None:
            logger.info(f"training over a data axis of {shard.count} ranks")
        size = tuple(cfg.image_size)
        if cfg.dataset:
            ds_train = build_dataset(dict(cfg.dataset), split="train")
            ds_eval = build_dataset(dict(cfg.dataset), split="validation")
            self.num_classes = getattr(ds_train, "num_classes", cfg.num_classes)
        else:
            ds_train = Synthetic(512, size + (3,), cfg.num_classes, split="train")
            ds_eval = Synthetic(128, size + (3,), cfg.num_classes, split="validation")
            self.num_classes = cfg.num_classes

        def mk(ds, shuffle, aug=None):
            return Loader(ds, cfg.batch_size, shuffle=shuffle, drop_last=True, mean=cfg.mean,
                          std=cfg.std, image_size=size, device=self.device, aug=aug,
                          sharding=shard and (shard.index, shard.count))

        loader_train, loader_eval = mk(ds_train, True, cfg.aug), mk(ds_eval, False)
        steps = len(loader_train)
        if cfg.max_steps_per_epoch:
            steps = min(steps, cfg.max_steps_per_epoch)

        optim_args = Config(dict(opt=cfg.opt, lr=cfg.lr, momentum=cfg.momentum,
                                 weight_decay=cfg.weight_decay, eps=cfg.eps,
                                 clip_grad=cfg.clip_grad, clip_mode=cfg.clip_mode))
        sche_args = Config(dict(epochs=cfg.epochs, sched=cfg.sched, min_lr=cfg.min_lr,
                                warmup_epochs=cfg.warmup_epochs, decay_rate=cfg.decay_rate))

        def optimizer(pipe=None):
            named = [(n, p) for n, p in model.named_parameters() if not p.is_meta]
            return make_optimizer(named, optim_args, sche_args, steps,
                                  every_k=int(cfg.grad_accum or 1), data=shard, pipe=pipe)[0]

        self.optimizer = optimizer()
        if float(cfg.ema_decay or 0.0) > 0.0:
            self.ema = copy.deepcopy(model).eval().requires_grad_(False)

        out_dir = cfg.work_dir
        saver = None
        # a sharded save is collective: every rank builds the saver (npz: the first only)
        if get_rank() == 0 or cfg.ckpt_backend == "sharded":
            saver = CheckpointSaver(out_dir, decreasing=(cfg.eval_metric == "loss"),
                                    max_history=cfg.checkpoint_hist, backend=cfg.ckpt_backend)
        start_epoch = self._resume() if cfg.resume else 0  # the whole model, before a release
        if mesh is not None and pp > 1:
            self._enable_pipeline(mesh, optimizer)
        if mesh is not None and mp > 1:
            self._enable_tp(mesh, optimizer)
        self._all = {n for n, _ in self.optimizer.named}

        self._best = (None, None)
        guard = PreemptionGuard()
        guard.__enter__()  # SIGTERM -> a cooperative stop and checkpoint
        self._guard = guard
        generator = torch.Generator(device=self.device)
        try:
            with drop_generator(model, generator):
                self._loop(loader_train, loader_eval, steps, saver, out_dir, start_epoch,
                           generator)
        except KeyboardInterrupt:
            pass  # a partial run still reports its best metric
        except Preempted as e:
            if saver is not None or self._collective_checkpoint:
                variables, opt = self._checkpoint()
                if saver is not None:
                    path = saver.save_last(variables, e.args[0] - 1, opt_state=opt)
                    logger.warning(f"preempted: full train state saved to {path}")
        finally:
            self._guard = None
            guard.__exit__()
            model.eval()
            if saver is not None:
                saver.wait()  # the last asynchronous save commits before train returns
        for carrier in self.carriers:  # each block's trained weights, from its owner
            carrier.enable_pipeline(None)
        self.carriers = []
        if self.tp is not None:  # the whole trained model on every rank
            for m in (self.model, self.ema):
                if m is not None:
                    unshard_module(m)
            self.tp = None
        best_metric, best_epoch = self._best
        logger.info(f"*** Best {cfg.eval_metric}: {best_metric} (epoch {best_epoch})")
        return dict(best_metric=best_metric, best_epoch=best_epoch, model=model, ema=self.ema)

    def _enable_pipeline(self, mesh, optimizer):
        """Pipeline the model's stages (and the EMA's) over ``mesh``'s model
        axis, and rebuild the optimizer over the parameters left on this rank,
        with the state it had for them."""
        from convnet_approximater_tpu_torch.hooks.finetune import carry_state

        logger = get_logger()
        cfg = self.cfg
        if resolve_pipeline_carrier(self.model) is None:
            logger.warning(f"pipeline_parallel={cfg.pipeline_parallel}: "
                           f"{type(self.model).__name__} has no pipeline-capable stage engine: "
                           f"trained unpipelined")
        else:
            self.carriers = [resolve_pipeline_carrier(m) for m in (self.model, self.ema)
                             if m is not None]
            for carrier in self.carriers:
                carrier.enable_pipeline(mesh, num_microbatches=cfg.pipeline_microbatches)
        index, n, _, _ = axis_ranks(mesh, MODEL_AXIS)
        blocks = block_names(self.model)
        owned = {name for name, _ in self.model.named_parameters()
                 if owner_of(name, blocks) == index}
        old, self.optimizer = self.optimizer, optimizer(pipe_axis(mesh, owned))
        carry_state(old, self.optimizer)
        if self.carriers:
            logger.info(f"pipelined stages {self.carriers[0].pipelined_stages()} over {n} pipe "
                        f"ranks, {self.carriers[0]._pipeline['M']} microbatches")

    @property
    def _collective_checkpoint(self) -> bool:
        """Whether every rank takes part in a checkpoint (pipelined or sharded)."""
        return bool(self.carriers) or self.tp is not None

    def _enable_tp(self, mesh, optimizer):
        """Shard the model and the EMA over ``mesh``'s model axis
        (``parallel.tp.shard_module``) and rebuild the optimizer over the
        shards, with the rank's slices of the state it had."""
        from convnet_approximater_tpu_torch.hooks.finetune import carry_state

        cfg = self.cfg
        mp = int(cfg.model_parallel)
        shard_module(self.model, mesh, mp, cfg.tp_rules)
        if self.ema is not None:
            shard_module(self.ema, mesh, mp, cfg.tp_rules, warn=False)
        self.tp = plan = tp_plan(self.model)
        old, self.optimizer = self.optimizer, optimizer(pipe_axis(mesh, plan.dims, plan.dims))
        carry_state(old, self.optimizer, plan)
        get_logger().info(summary(self.model))

    def _variables(self) -> dict:
        """What a checkpoint holds besides the optimizer: params, state and ``ema``."""
        tree = variables_of(self.model)
        if self.ema is not None:
            tree["ema"] = variables_of(self.ema)
        return tree

    def _checkpoint(self):
        """``(variables, optimizer state)`` of a checkpoint.  Pipelined, it is
        collective over the pipe group: for npz the whole model, each block's
        weights and optimizer state from its owner; for a sharded save this
        rank's own blocks and the replicated parts (each pipe rank writes the
        blocks it owns).  Sharded (tensor parallelism), it is the whole model,
        EMA and optimizer state for both backends, gathered over the model group."""
        from convnet_approximater_tpu_torch.hooks.finetune import (gathered_opt_state,
                                                                   opt_state_to_tree)

        if self.tp is not None:  # the whole model and state, gathered over the model group
            tree = unflatten_tree(params_to_jax(gather_tensors(self.model.state_dict(), self.tp)))
            if self.ema is not None:
                tree["ema"] = unflatten_tree(params_to_jax(
                    gather_tensors(self.ema.state_dict(), tp_plan(self.ema))))
            return tree, gathered_opt_state(self.optimizer, self.tp)
        if not self.carriers:
            return self._variables(), self.optimizer

        sharded = self.cfg.ckpt_backend == "sharded"

        def tree_of(model):
            state = model.state_dict()
            state = ({k: v for k, v in state.items() if not v.is_meta} if sharded
                     else gather_from_owners(self.model, state, self.device))
            return unflatten_tree(params_to_jax(state))

        tree = tree_of(self.model)
        if self.ema is not None:
            tree["ema"] = tree_of(self.ema)
        opt = opt_state_to_tree(self.optimizer)
        if not sharded:
            kinds = list(next(iter(self.optimizer.state.values())))
            named = {f"{n}/{k}": self.optimizer.state[n][k] if n in self.optimizer.state else p
                     for n, p in self.model.named_parameters() for k in kinds}
            for key, t in gather_from_owners(self.model, named, self.device).items():
                name, k = key.rsplit("/", 1)
                opt.setdefault(name, {})[k] = t.detach().cpu().numpy().copy()
        return tree, opt

    def _resume(self) -> int:
        """Load ``resume`` (a checkpoint of either package) into the model, the
        EMA and the optimizer; the epoch to start from."""
        from convnet_approximater_tpu_torch.hooks.finetune import (opt_state_from_jax,
                                                                   opt_state_from_tree)

        logger = get_logger()
        path = self.cfg.resume
        flat = load_flat(path)
        load_jax_flat(self.model, flat)
        restored = []
        if self.ema is not None and any(k.startswith("ema/") for k in flat):
            load_jax_flat(self.ema, {k[4:]: v for k, v in flat.items() if k.startswith("ema/")})
            restored.append("ema")
        ckpt = unflatten_tree(flat)
        if "opt" in ckpt:
            opt = ckpt["opt"]
            if (opt_state_from_tree(opt, self.optimizer) is None
                    and opt_state_from_jax(opt, self.optimizer) is None):
                logger.warning("resume: optimizer state structure mismatch; "
                               "keeping a fresh optimizer")
            else:
                restored.append("optimizer")
        start_epoch = 0
        if "meta" in ckpt and "epoch" in ckpt["meta"]:
            start_epoch = int(ckpt["meta"]["epoch"]) + 1
        logger.info(f"resumed from {path} (epoch {start_epoch}"
                    + (f"; {', '.join(restored)}" if restored else "") + ")")
        return start_epoch

    def _loop(self, loader_train, loader_eval, steps, saver, out_dir, start_epoch, generator):
        from convnet_approximater_tpu_torch.hooks.finetune import step_seed, update_summary

        logger = get_logger()
        cfg = self.cfg
        seed = int(cfg.seed)
        step_count = start_epoch * steps
        for epoch in range(start_epoch, cfg.epochs):
            loader_train.set_epoch(epoch)
            loss_m, time_m = AverageMeter(), AverageMeter()
            end = time.time()
            for i, (images, labels) in enumerate(loader_train):
                if i >= steps:
                    break
                if self._guard is not None and self._guard.stop_requested(self._stop_axis):
                    raise Preempted(epoch)
                generator.manual_seed(step_seed(seed, step_count))
                loss = self.train_step(images, labels, step_count)
                step_count += 1
                if i % cfg.log_interval == 0 or i == steps - 1:
                    # the global batch's mean: every rank holds as many rows
                    bs = images.shape[0]
                    loss, bs = sum_over([float(loss) * bs, bs], self.shard, images.device)
                    loss_m.update(loss / bs, bs)
                    time_m.update(time.time() - end)
                    logger.info(
                        f"Train: {epoch} [{i:>4d}/{steps}]  Loss: {loss_m.val:#.4g} "
                        f"({loss_m.avg:#.3g})  LR: {self.optimizer.lr(self.optimizer.count):.3e}  "
                        f"Time: {time_m.val:.3f}s")
                end = time.time()
            eval_metrics = self.validate(loader_eval)
            logger.info(f"Eval {epoch}: {eval_metrics}")
            if get_rank() == 0:
                update_summary(epoch, dict(loss=loss_m.avg), eval_metrics,
                               os.path.join(out_dir, "summary.csv"), write_header=(epoch == 0))
            if saver is not None or self._collective_checkpoint:
                variables, opt = self._checkpoint()
                if saver is not None:
                    self._best = saver.save_checkpoint(variables, epoch,
                                                       eval_metrics[cfg.eval_metric],
                                                       opt_state=opt)

    def validate(self, loader) -> dict:
        """Loss, top-1 and top-5 over the validation batches, on the EMA weights
        when the EMA is on; across processes each batch's sums go over the
        data axis."""
        model = self.ema if self.ema is not None else self.model
        model.eval()
        lm, t1, t5 = AverageMeter(), AverageMeter(), AverageMeter()
        for j, (images, labels) in enumerate(loader):
            if self.cfg.max_eval_batches and j >= self.cfg.max_eval_batches:
                break
            loss, c1, c5, _ = eval_batch(model, images, labels)
            bs = images.shape[0]
            if self.shard is not None:
                loss, c1, c5, bs = sum_over([float(loss) * bs, float(c1), float(c5), bs],
                                            self.shard, images.device)
                loss, bs = loss / bs, int(bs)
            lm.update(float(loss), bs)
            t1.update(float(c1) / bs * 100, bs)
            t5.update(float(c5) / bs * 100, bs)
        return dict(loss=lm.avg, top1=t1.avg, top5=t5.avg)
