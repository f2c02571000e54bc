"""L2Reconstruct: fine-tuning by per-layer L2 reconstruction, cross-entropy
and logit distillation (port of ``convnet_approximater_tpu/hooks/finetune.py``).

The hook trains ``runner.model`` in place on ``runner.device`` after the
Optimize phase:

* **asym** keeps a frozen teacher, the original model: a deep copy of the
  student taken before training, with every Substitution switched to its
  ``old`` branch and ``new`` removed (what the JAX hook's rebuild computes);
  after structure passes, the model as it stood before them, its sites
  wrapped the same way (the JAX hook rebuilds it from the config and runs no
  pass); the student keeps only its ``new`` branches.
* **sym** keeps both branches on the student; the teacher pass is the
  student's own forward forced down the ``old`` branches
  (:func:`~convnet_approximater_tpu_torch.layers.forced_branch`).
* Either teacher pass runs in ``eval()`` under ``torch.no_grad()``, so the
  kernel layers on it take their kernels, and the sym pass runs *before* the
  student's training forward, so it reads the BatchNorm state from before
  the step, as the JAX step does.
* The loss is the JAX step's: the per-sample norm of each captured
  Substitution's output difference, averaged over the taps and then over the
  batch, plus ``cls_weight`` times the task loss (``_ce_fn``: cross-entropy
  here, the per-pixel one in ``SegL2Reconstruct``) and ``kd_weight``
  T^2-scaled soft-target KL over the class axis.  A subclass also overrides
  ``_default_datasets`` and ``_validate``.
* The optimizer keeps every parameter, with one step count for all of them
  (:class:`MaskedOptimizer`): frozen parameters get zero gradients before the
  step, so their moments decay as optax's do, and zero updates, so decoupled
  weight decay cannot move them.  ``old`` branches are always frozen.
* DropPath and Dropout masks come from a generator the hook owns, seeded from
  the run's seed and the step count (the JAX hook's ``fold_in(rng, step)``).
* ``other_args.amp`` computes in bf16 over float32 masters, as the JAX step
  does: the student's forward runs on bf16 casts of its floating parameters
  (``torch.func.functional_call`` with :func:`~convnet_approximater_tpu_torch.utils.dtype.cast_params`,
  so the gradients reach the float32 masters through the casts) and on bf16
  images; the logits go back to float32 before the loss and the tap
  differences are taken in float32; the masters, their gradients, the
  optimizer state and BatchNorm's running statistics stay float32, and there
  is no loss scaling.  The asym teacher is a bf16 copy made once
  (``cast_floating``: it is frozen); the sym teacher is the student's forward
  on bf16 copies of its parameters, kept in one set of tensors that each step
  overwrites, so the kernel layers' caches, keyed by address and version,
  see each step's weights.
* SIGTERM stops at the next step boundary and saves the full train state
  (:class:`~convnet_approximater_tpu_torch.utils.preempt.PreemptionGuard`);
  ``resume`` restores weights, optimizer and epoch from a checkpoint of
  either package (a JAX one's optax leaves through :func:`opt_state_from_jax`).
* ``other_args.use_mesh`` (the default) in a process group of more than one
  rank trains data-parallel, as the JAX hook's SPMD step over its mesh's data
  axis (``parallel/data_parallel.py``): every rank takes the first rank's
  weights, loads only its rows of each global batch (the ``Loader``'s
  ``sharding=``, augmentation drawn per global batch), runs the teacher and
  the student on them with BatchNorm's batch statistics and the drop masks
  over the global batch, and the update averages the gradients over the
  ranks, so every rank computes what one process computes on the whole
  batch; the logged means and the validation sums are the global batch's,
  and the ranks decide a preemption stop together.
* ``other_args.model_parallel=mp`` > 1 (with ``tp_rules``,
  ``parallel/tp.py``) trains tensor-parallel on a ``(world / mp, mp)`` mesh,
  as the JAX hook's ``shard_variables``: every rank takes the first rank's
  weights, the asym teacher stays whole (replicated), and after a ``resume``
  the student keeps its shards of every parameter a rule shards
  (``parallel.tp.shard_module``): the optimizer holds the shards' moments,
  the replicated parameters' gradients come from model rank 0, and the
  checkpoints (either backend) hold the whole model and optimizer state,
  gathered over the model group; the student is gathered whole again when
  the hook returns.  One process (or ``use_mesh`` off) trains unsharded,
  with a warning.

Checkpoints are the JAX package's flat npz layout, with the optimizer state
under ``opt`` and the epoch and metric under ``meta``, or with
``other_args.ckpt_backend="sharded"`` the same tree in asynchronous
``torch.distributed.checkpoint`` directories (:class:`CheckpointSaver`);
``resume`` reads either.  The model goes back to
``eval()`` when the hook returns.
"""

from __future__ import annotations

import copy
import os
import shutil
import time
from typing import Callable, Dict, Iterable, Optional, Set, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from convnet_approximater_tpu_torch.classification import AverageMeter, eval_batch
from convnet_approximater_tpu_torch.convert import (load_jax_flat, params_from_jax, params_to_jax,
                                                   variables_of)
from convnet_approximater_tpu_torch.data import Loader, Synthetic, build_dataset
from convnet_approximater_tpu_torch.data.loader import check_aug
from convnet_approximater_tpu_torch.filters import build_filter
from convnet_approximater_tpu_torch.layers import (QATConv2d, QATLinear, Substitution,
                                                   drop_generator, forced_branch, release_taps,
                                                   taps)
from convnet_approximater_tpu_torch.models.switchable import set_submodule
from convnet_approximater_tpu_torch.nn import DataShard, sharded_batch
from convnet_approximater_tpu_torch.parallel.data_parallel import (average_gradients,
                                                                   broadcast_gradients, pipe_axis,
                                                                   replicate_from_root, sum_over,
                                                                   training_axis, training_mesh)
from convnet_approximater_tpu_torch.parallel.spatial import is_spatial, refuse_spatial
from convnet_approximater_tpu_torch.parallel.tp import (gather_tensor, gather_tensors, shard_module,
                                                        slice_tensor, summary, tp_plan,
                                                        unshard_module)
from convnet_approximater_tpu_torch.utils import (get_logger, get_rank, load_flat, save_model,
                                                  unflatten_tree)
from convnet_approximater_tpu_torch.utils.config import Config
from convnet_approximater_tpu_torch.utils.dtype import cast_floating, cast_params
from convnet_approximater_tpu_torch.utils.preempt import Preempted, PreemptionGuard
from convnet_approximater_tpu_torch.utils.sharded_ckpt import (checkpoint_group, save_sharded,
                                                              wait_for_saves)

from .hook import HOOK, Hook

_default_dataset_args = dict(
    dataset=None,  # DATASET registry cfg; None -> Synthetic data
    batch_size=64,
)

_default_data_config = dict(
    image_size=(224, 224),
    mean=(0.485, 0.456, 0.406),
    std=(0.229, 0.224, 0.225),
    # train-loader augmentation (hflip, crop_pad, rrc_scale); None = none, the
    # reference's L2 phase
    aug=None,
)

_default_optim_args = dict(opt="adamw", lr=1e-3, momentum=0.9, weight_decay=0.05, eps=1e-8)

_default_sche_args = dict(epochs=20, sched=None, min_lr=1e-6, warmup_epochs=0, decay_rate=0.1)

_default_other_args = dict(
    log_interval=50,
    resume="",
    start_epoch=None,
    eval_metric="top1",
    checkpoint_hist=10,
    num_classes=10,
    max_steps_per_epoch=None,  # cap for smoke runs
    max_eval_batches=None,
    use_mesh=True,
    model_parallel=1,
    tp_rules=None,
    amp=False,
    ckpt_backend="npz",
)


def _combine(default: dict, new: dict) -> Config:
    cfg = Config()
    cfg.update(default)
    cfg.update(new or {})
    return cfg


# -- optimizer ---------------------------------------------------------------
def lr_schedule(optim_args: Config, sche_args: Config,
                steps_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of update ``count`` (counted from 0), as the JAX
    hook's optax schedule gives it, in float32 as optax computes it:
    ``cosine`` is ``warmup_cosine_decay_schedule(0, lr, warmup, epochs *
    steps, min_lr)`` (its decay steps include the warmup, so a warmup makes
    lr(0) = 0), ``step`` a staircase ``exponential_decay`` by ``decay_rate``
    per epoch, anything else the constant ``lr``."""
    f32 = np.float32
    base = float(optim_args.lr)
    sched = sche_args.sched
    if sched in ("cosine", "cosine_annealing"):
        warmup = int(sche_args.warmup_epochs * steps_per_epoch)
        decay = sche_args.epochs * steps_per_epoch - warmup
        if decay <= 0:
            raise ValueError(f"cosine schedule: {sche_args.epochs} epochs of {steps_per_epoch} "
                             f"steps leave no decay steps after {warmup} warmup steps")
        alpha = f32(0.0 if base == 0.0 else sche_args.min_lr / base)

        def cosine(count: int) -> float:
            if count < warmup:  # optax.linear_schedule(0, lr, warmup)
                return float(f32(0.0 - base) * (f32(1) - f32(count) / f32(warmup)) + f32(base))
            c = f32(min(count - warmup, decay))
            cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
            return float(f32(base) * ((f32(1) - alpha) * cos + alpha))

        return cosine
    if sched == "step" and steps_per_epoch > 0 and sche_args.decay_rate != 0:
        rate = f32(sche_args.decay_rate)
        return lambda count: base if count <= 0 else float(
            f32(base) * rate ** f32(count // steps_per_epoch))
    return lambda count: base


def unitwise_norm(x: torch.Tensor, name: str, axis=None) -> torch.Tensor:
    """optax's ``unitwise_norm`` of the JAX package's layout of parameter
    ``name``, in the port's: a conv weight OIHW is HWIO there (norm over each
    output channel), a Linear weight (out, in) is (in, out) there (norm over
    each output unit).  ``axis`` (a ``parallel.PipeAxis`` with ``dims``):
    where ``x`` is a tensor-parallel shard whose sharded dim the norm sums
    over, the squares are summed over the model group."""
    transposed = name.rsplit(".", 1)[-1] in ("weight", "weight_q")
    if x.squeeze().dim() <= 1:
        dims = None
    elif x.dim() == 2:
        dims = (1,) if transposed else (0,)
    elif x.dim() == 3:
        dims = (0,)
    elif x.dim() == 4:
        dims = (1, 2, 3) if transposed else (0, 1, 2)
    else:
        raise ValueError(f"adaptive clipping: parameter {name} of shape {tuple(x.shape)} "
                         f"has no unit-wise norm")
    sq = x.pow(2).sum() if dims is None else x.pow(2).sum(dim=dims, keepdim=True)
    d = axis.dims.get(name) if axis is not None and axis.dims else None
    if d is not None and (dims is None or d in dims):
        dist.all_reduce(sq, group=axis.group)
    return sq.sqrt()


class MaskedOptimizer:
    """The JAX hook's optax optimizer, in torch's foreach tensor ops with
    optax's arithmetic, over every parameter of a model, stepped under a
    freeze mask.

    * ``adamw``: ``optax.adamw``, weight decay added to the update before the
      learning rate scales it (decoupled);
    * ``adam`` and ``sgd``/``momentum``: ``optax.adam`` / ``optax.sgd``, with
      no weight decay whatever ``optim_args`` says, as optax's take none;
    * the learning rate of update n is :func:`lr_schedule`'s lr(n);
    * ``clip_grad`` > 0 clips the masked gradients first, by ``clip_mode``:
      ``norm`` (global norm, with no epsilon added), ``value`` or ``agc``
      (unit-wise, against the parameters' norms), as optax does;
    * ``every_k`` > 1 is ``optax.MultiSteps(every_k_schedule=every_k)``: each
      step adds its gradients into a running mean (``acc += (g - acc) / (n +
      1)``, per parameter under ``acc``), and only every k-th step updates, on
      the mean; the schedule counts updates;
    * ``data`` (a data axis, ``nn.DataShard``): each update first averages
      the trainable parameters' gradients over the data axis
      (``parallel.average_gradients``), once per update, after the
      micro-steps' mean and before clipping, as the JAX step's gradient of a
      global batch's loss;
    * ``pipe`` (the model axis, ``parallel.PipeAxis``: the optimizer holds
      only the parameters present on this rank, a pipe rank's blocks or a
      tensor-parallel rank's shards): then the parameters outside ``owned``
      take model rank 0's gradients (a broadcast over the model group), and
      ``norm`` clipping takes the global norm, the owned parameters' squares
      summed over the model group and the replicated ones counted once
      (``agc`` sums a shard's unit-wise squares over the group where its
      sharded dim is summed).

    optax takes Adam's bias corrections ``1 - b^t`` in float32, where
    ``torch.optim.Adam`` takes them in float64: after 5 steps the two differ
    by 6e-6 relative, so this optimizer does not wrap ``torch.optim``.  The
    state (zero moments, or a zero momentum trace) is made at construction
    and has one step count for all parameters, as optax's.
    """

    B1, B2 = 0.9, 0.999  # optax.adam(w)'s defaults

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]], optim_args: Config,
                 sche_args: Config, steps_per_epoch: int, every_k: int = 1, data=None,
                 pipe=None):
        self.named = list(named_params)
        self.data = data
        self.pipe = pipe
        self.kind = optim_args.opt
        if self.kind == "adamw":
            self.weight_decay = float(optim_args.weight_decay)
        elif self.kind in ("adam", "sgd", "momentum"):
            self.weight_decay = 0.0
        else:
            raise ValueError(f"unknown optimizer {self.kind}")
        self.eps = float(optim_args.eps)
        self.momentum = float(optim_args.momentum or 0.0)
        self.lr = lr_schedule(optim_args, sche_args, steps_per_epoch)
        self.clip = float(optim_args.clip_grad or 0.0)
        self.clip_mode = optim_args.clip_mode or "norm"
        if self.clip > 0 and self.clip_mode not in ("norm", "value", "agc"):
            raise ValueError(f"unknown clip_mode {self.clip_mode}")
        self.count = 0
        self.every_k = int(every_k)
        self.mini_step = 0
        names = ("trace",) if self.kind in ("sgd", "momentum") else ("mu", "nu")
        if self.every_k > 1:
            names += ("acc",)
        self.state = {name: {k: torch.zeros_like(p) for k in names} for name, p in self.named}

    def zero_grad(self):
        for _, p in self.named:
            p.grad = None

    def _clip(self, grads, params):
        if self.clip <= 0:
            return
        if self.clip_mode == "value":
            torch._foreach_clamp_min_(grads, -self.clip)
            torch._foreach_clamp_max_(grads, self.clip)
        elif self.clip_mode == "norm":
            squares = [g.pow(2).sum() for g in grads]
            if self.pipe is None:
                norm = torch.stack(squares).sum().sqrt()
            else:  # the owned blocks' squares over the pipe group, the replicated ones once
                owned = [q for (name, _), q in zip(self.named, squares) if name in self.pipe.owned]
                own = torch.stack(owned).sum() if owned else squares[0].new_zeros(())
                dist.all_reduce(own, group=self.pipe.group)
                norm = (torch.stack([q for (name, _), q in zip(self.named, squares)
                                     if name not in self.pipe.owned]).sum() + own).sqrt()
            for g in grads:
                g.copy_(torch.where(norm < self.clip, g, g / norm * self.clip))
        else:
            for (name, _), g, p in zip(self.named, grads, params):
                g_norm = unitwise_norm(g, name, self.pipe)
                max_norm = self.clip * unitwise_norm(p, name, self.pipe).clamp_min(1e-3)
                g.copy_(torch.where(g_norm < max_norm, g, g * (max_norm / g_norm.clamp_min(1e-6))))

    @torch.no_grad()
    def step(self, trainable: Set[str]):
        """One update of the parameters named in ``trainable``; every other one
        steps on a zero gradient and keeps its value (optax's moments decay,
        and the masked update leaves it)."""
        params = [p for _, p in self.named]
        grads = [p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        states = [self.state[name] for name, _ in self.named]
        if self.every_k > 1:  # optax.MultiSteps: the running mean of the micro-steps' gradients
            acc = [s["acc"] for s in states]
            torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(grads, acc),
                                                        float(self.mini_step + 1)))
            self.mini_step = (self.mini_step + 1) % self.every_k
            if self.mini_step:
                return
            grads = [a.clone() for a in acc]
            torch._foreach_zero_(acc)
        frozen = [i for i, (name, _) in enumerate(self.named) if name not in trainable]
        if self.data is not None:
            average_gradients([g for (name, _), g in zip(self.named, grads) if name in trainable],
                              self.data)
        if self.pipe is not None:
            broadcast_gradients([g for (name, _), g in zip(self.named, grads)
                                 if name in trainable and name not in self.pipe.owned], self.pipe)
        for i in frozen:
            grads[i].zero_()
        self._clip(grads, params)
        if self.kind in ("sgd", "momentum"):
            trace = [s["trace"] for s in states]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            updates = [t.clone() for t in trace]
        else:
            mu, nu = [s["mu"] for s in states], [s["nu"] for s in states]
            torch._foreach_mul_(mu, self.B1)
            torch._foreach_add_(mu, grads, alpha=1 - self.B1)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_add_(nu, torch._foreach_mul(grads, grads), alpha=1 - self.B2)
            t = np.float32(self.count + 1)
            bc1 = float(np.float32(1) - np.float32(self.B1) ** t)
            bc2 = float(np.float32(1) - np.float32(self.B2) ** t)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if self.weight_decay:
                torch._foreach_add_(updates, params, alpha=self.weight_decay)
        for i in frozen:
            updates[i].zero_()
        torch._foreach_add_(params, updates, alpha=-self.lr(self.count))
        self.count += 1


def make_optimizer(named_params, optim_args: Config, sche_args: Config,
                   steps_per_epoch: int, every_k: int = 1, data=None, pipe=None
                   ) -> Tuple[MaskedOptimizer, Callable[[int], float]]:
    """The optimizer and its learning-rate schedule (timm's
    ``create_optimizer_v2``/``create_scheduler`` in the reference)."""
    opt = MaskedOptimizer(named_params, optim_args, sche_args, steps_per_epoch, every_k, data,
                          pipe)
    return opt, opt.lr


def carry_state(old: MaskedOptimizer, new: MaskedOptimizer, plan=None) -> None:
    """Give ``new`` (an optimizer over some of ``old``'s parameters) their
    state in ``old``, cut to this rank's slices where ``plan`` (a
    tensor-parallel ``TPPlan``) shards them, and ``old``'s counts."""
    for name in new.state:
        new.state[name] = {k: v if plan is None else slice_tensor(plan, name, v)
                           for k, v in old.state[name].items()}
    new.count, new.mini_step = old.count, old.mini_step


def opt_state_to_tree(opt: MaskedOptimizer) -> dict:
    """The optimizer's state as a tree of numpy arrays: its update count, and
    per parameter name its moments (``mu``, ``nu``) or momentum ``trace``; with
    ``every_k`` > 1 also the micro-step and each parameter's accumulated ``acc``."""
    tree = {"count": np.int64(opt.count)}
    if opt.every_k > 1:
        tree["mini_step"] = np.int64(opt.mini_step)
    for name, state in opt.state.items():
        tree[name] = {k: v.detach().cpu().numpy().copy() for k, v in state.items()}
    return tree


def gathered_opt_state(opt: MaskedOptimizer, plan) -> dict:
    """:func:`opt_state_to_tree` with each tensor-parallel shard's state
    gathered whole over the model axis (``plan``, a ``TPPlan``): collective."""
    tree = opt_state_to_tree(opt)
    for name, state in opt.state.items():
        if name in plan.dims:
            tree[name] = {k: gather_tensor(plan, name, v).cpu().numpy().copy()
                          for k, v in state.items()}
    return tree


def opt_state_from_tree(tree: dict, opt: MaskedOptimizer) -> Optional[MaskedOptimizer]:
    """Restore :func:`opt_state_to_tree`'s tree into ``opt``; returns ``opt``,
    or None, leaving ``opt`` as it was, when the structure differs (another
    optimizer, another model, or a JAX package's checkpoint)."""
    expected = opt_state_to_tree(opt)
    if set(tree) != set(expected):
        return None
    for name, _ in opt.named:
        if not isinstance(tree[name], dict) or set(tree[name]) != set(expected[name]):
            return None
        if any(np.shape(tree[name][k]) != np.shape(v) for k, v in expected[name].items()):
            return None
    with torch.no_grad():
        for name, state in opt.state.items():
            for k, v in state.items():
                v.copy_(torch.from_numpy(np.asarray(tree[name][k])))
    opt.count = int(tree["count"])
    if opt.every_k > 1:
        opt.mini_step = int(tree["mini_step"])
    return opt


def opt_state_from_jax(tree: dict, opt: MaskedOptimizer) -> Optional[MaskedOptimizer]:
    """Restore into ``opt`` an optax state that the JAX package saved (its
    leaves under ``00000``, ``00001``, ... in flattening order), laid out as the
    JAX ``make_optimizer`` builds it for ``opt``'s kind: Adam's count, ``mu``
    and ``nu`` or SGD's ``trace``, each over the parameters in the JAX tree's
    order (keys sorted at every level), then a schedule's count if the
    learning rate is one; wrapped in ``optax.MultiSteps``'s ``mini_step``,
    ``gradient_step`` and ``acc_grads`` when ``every_k`` > 1.  Returns ``opt``,
    or None, leaving ``opt`` as it was, when the leaves do not fit."""
    if sorted(tree) != [f"{i:05d}" for i in range(len(tree))]:
        return None
    leaves = [np.asarray(tree[f"{i:05d}"]) for i in range(len(tree))]
    params = dict(opt.named)
    jax_names = {next(iter(params_to_jax({n: p.detach()}))): n for n, p in opt.named}
    order = sorted(jax_names, key=lambda k: tuple(k.split("/")))
    n = len(order)

    def per_param(vals):
        if len(vals) != n:
            return None
        out = {}
        for key, v in zip(order, vals):
            name = jax_names[key]
            t = params_from_jax({key: v})[name]
            if t.shape != params[name].shape:
                return None
            out[name] = t
        return out

    restored, mini_step = {}, None
    if opt.every_k > 1:
        if len(leaves) < 2 + n:
            return None
        mini_step, count = int(leaves[0]), int(leaves[1])
        restored["acc"], leaves = per_param(leaves[-n:]), leaves[2:-n]
    else:
        count = 0
    if opt.kind in ("sgd", "momentum"):
        restored["trace"], rest = per_param(leaves[:n]), leaves[n:]
    else:
        if not leaves:
            return None
        count = int(leaves[0])
        restored["mu"], restored["nu"] = per_param(leaves[1:1 + n]), per_param(leaves[1 + n:1 + 2 * n])
        rest = leaves[1 + 2 * n:]
    if len(rest) > 1 or any(v is None for v in restored.values()) or any(
            np.shape(v) != () for v in rest):
        return None
    if rest:
        count = int(rest[0])  # the schedule's count: updates
    with torch.no_grad():
        for k, vals in restored.items():
            for name, v in vals.items():
                opt.state[name][k].copy_(v)
    opt.count = count
    if mini_step is not None:
        opt.mini_step = mini_step
    return opt


# -- checkpoints -------------------------------------------------------------
def _link(src: str, dst: str):
    """Make ``dst`` the file ``src`` (a hard link where the file system has
    them), replacing what was there at once."""
    if os.path.exists(dst) and os.path.samefile(src, dst):
        return  # a rename onto another link of the same file would do nothing
    tmp = dst + ".tmp"
    if os.path.lexists(tmp):
        os.remove(tmp)
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def _relink(target: str, link: str):
    """Make ``link`` a symlink to ``target`` (a sibling in the same directory),
    replacing what was there at once."""
    tmp = link + ".tmp"
    if os.path.lexists(tmp):
        os.remove(tmp)
    os.symlink(os.path.basename(target), tmp)
    os.replace(tmp, link)


class CheckpointSaver:
    """Best-k checkpoint keeper (timm ``CheckpointSaver`` analog).

    A checkpoint carries the full train state (weights, optimizer state,
    epoch, metric), so a killed fine-tune resumes exactly.  Loads for serving
    ignore the ``opt``/``meta`` collections.  Two backends:

    * ``npz``: one flat ``checkpoint-<epoch>.ckpt.npz`` per epoch; ``last`` and
      ``model_best`` name the same files as the epoch checkpoints they stand
      for (hard links where the file system has them);
    * ``sharded``: a ``checkpoint-<epoch>.ckpt.dcp`` directory per epoch
      (``utils/sharded_ckpt.py``), saved asynchronously (the next save, a
      restore or :meth:`wait` waits for it), ``last.ckpt.dcp`` and
      ``model_best.ckpt.dcp`` symlinks to epoch directories, and best-k
      pruning that never removes the directory ``last`` points at; the
      preemption save is synchronous, into ``checkpoint-preempt.ckpt.dcp``.
      Its ``meta`` holds Python scalars, as the JAX saver's does.  Across
      processes every rank builds this saver and saves (the save is
      collective, over a gloo group the saver makes), and the first rank
      alone makes the links and prunes; an ``npz`` saver is built on the
      first rank only, as the JAX trainers build theirs."""

    def __init__(self, out_dir: str, decreasing: bool = False, max_history: int = 10,
                 backend: str = "npz"):
        if backend not in ("npz", "sharded"):
            raise ValueError(f"unknown ckpt backend {backend!r}")
        self.out_dir = out_dir
        self.decreasing = decreasing
        self.max_history = max_history
        self.backend = backend
        self.suffix = ".ckpt.dcp" if backend == "sharded" else ".ckpt.npz"
        self.history = []  # (metric, path, epoch)
        self.main = get_rank() == 0  # links and prunes (every rank saves a sharded checkpoint)
        self.group = checkpoint_group() if backend == "sharded" else None
        os.makedirs(out_dir, exist_ok=True)

    def _name(self, stem: str) -> str:
        return os.path.join(self.out_dir, stem + self.suffix)

    def _tree(self, variables: dict, epoch: int, metric: float, opt_state) -> dict:
        tree = dict(variables)
        if opt_state is not None:  # an optimizer, or the tree of one
            tree["opt"] = opt_state if isinstance(opt_state, dict) else opt_state_to_tree(opt_state)
        if self.backend == "sharded":
            tree["meta"] = {"epoch": int(epoch), "metric": float(metric)}
        else:
            tree["meta"] = {"epoch": np.int64(epoch), "metric": np.float64(metric)}
        return tree

    def save_checkpoint(self, variables: dict, epoch: int, metric: float, opt_state=None):
        path = self._name(f"checkpoint-{epoch}")
        tree = self._tree(variables, epoch, metric, opt_state)
        if self.backend == "sharded":
            save_sharded(path, tree, wait=False, group=self.group)
            self._relink(path, "last")
        else:
            save_model(tree, path)
            _link(path, self._name("last"))
        self.history.append((metric, path, epoch))
        self.history.sort(key=lambda t: t[0], reverse=not self.decreasing)
        while len(self.history) > self.max_history:
            _, stale, _ = self.history.pop()
            if not self.main:
                continue
            if self.backend == "npz":
                if os.path.exists(stale):
                    os.remove(stale)
            elif (os.path.isdir(stale) and not os.path.islink(stale)
                  and os.path.realpath(stale) != os.path.realpath(self._name("last"))):
                shutil.rmtree(stale)
        best_metric, best_path, best_epoch = self.history[0]
        if self.backend == "sharded":
            self._relink(best_path, "model_best")
        else:
            _link(best_path, self._name("model_best"))
        return best_metric, best_epoch

    def _relink(self, target: str, stem: str):
        if self.main:
            _relink(target, self._name(stem))

    def save_last(self, variables: dict, epoch: int, opt_state=None) -> str:
        """Preemption save: only the ``last`` checkpoint (the best-k history is
        untouched).  ``epoch`` is the last completed epoch: a resume redoes the
        interrupted one from these weights."""
        tree = self._tree(variables, epoch, float("nan"), opt_state)
        if self.backend == "sharded":
            path = self._name("checkpoint-preempt")
            save_sharded(path, tree, wait=True, group=self.group)
            self._relink(path, "last")
            return path
        path = self._name("last")
        save_model(tree, path)
        return path

    def wait(self):
        """Block until the last asynchronous save has committed."""
        if self.backend == "sharded":
            wait_for_saves()


def update_summary(epoch: int, train_metrics: dict, eval_metrics: dict, path: str,
                   write_header: bool = False):
    """Per-epoch CSV log (timm ``update_summary`` analog)."""
    row = {"epoch": epoch}
    row.update({f"train_{k}": v for k, v in train_metrics.items()})
    row.update({f"eval_{k}": v for k, v in eval_metrics.items()})
    with open(path, "w" if write_header else "a") as f:
        if write_header:
            f.write(",".join(row.keys()) + "\n")
        f.write(",".join(str(v) for v in row.values()) + "\n")


def step_seed(seed: int, step: int) -> int:
    """The seed of the drop masks of training step ``step`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


# -- the hook ----------------------------------------------------------------
@HOOK.register_module()
class L2Reconstruct(Hook):
    def __init__(self, runner, priority, asym: bool = True, l2_weight: float = 1.0,
                 cls_weight: float = 0.0, kd_weight: float = 0.0,
                 kd_temperature: float = 4.0, epoch_behavior=(), no_norm: bool = False,
                 dataset_args=None, optim_args=None, sche_args=None,
                 data_config=None, other_args=None):
        super().__init__(runner, priority)
        self.asym = asym
        self.l2_weight = l2_weight
        self.cls_weight = cls_weight
        self.kd_weight = kd_weight
        self.kd_temperature = kd_temperature
        self.epoch_behavior = list(epoch_behavior)
        self.no_norm = no_norm
        self.dataset_args = _combine(_default_dataset_args, dataset_args)
        self.optim_args = _combine(_default_optim_args, optim_args)
        self.sche_args = _combine(_default_sche_args, sche_args)
        self.data_config = _combine(_default_data_config, data_config)
        self.other_args = _combine(_default_other_args, other_args)
        other = self.other_args
        self.amp = bool(other.amp)
        check_aug(self.data_config.aug)
        self.shard: Optional[DataShard] = None  # the data axis, across processes
        self.tp = None  # the student's tensor-parallel plan, while it is sharded
        self.teacher: Optional[nn.Module] = None
        self.optimizer: Optional[MaskedOptimizer] = None
        self.result = None
        self._guard = None
        self._bf16 = None  # the sym teacher's bf16 parameters under amp
        self._refuse_spatial(getattr(runner, "model", None))

    @staticmethod
    def _refuse_spatial(model) -> None:
        if model is not None and is_spatial(model):
            raise refuse_spatial("L2Reconstruct: training under spatial sharding")

    @property
    def need_teacher(self) -> bool:
        return (not self.no_norm) or self.kd_weight > 0

    # -- teacher ---------------------------------------------------------
    def _build_teacher(self) -> nn.Module:
        """The original model: a deep copy of the student with each Substitution
        on its ``old`` branch and without ``new`` (the new branches are not
        copied), or the Runner's model from before its structure passes, and
        each QAT twin back to its dense layer (the JAX hook rebuilds the
        teacher from the config, so its layers are float and unpruned), in
        ``eval()`` with no gradients."""
        runner = self.runner
        if runner.model_before_passes is not None:
            # the model before the structure passes, with the app's sites
            # registered on it as Substitutions that hold only ``old``
            teacher, runner.model_before_passes = runner.model_before_passes, None
            teacher.register_switchable(runner.app.src_type,
                                        [build_filter(f) for f in runner.cfg.filters or []])
            for idx in range(teacher.length_switchable):
                sub = Substitution(teacher.get_switchable_module(idx), nn.Identity())
                sub.switch_old(remove_new=True)
                teacher.set_switchable_module(idx, sub)
        else:
            model = runner.model
            subs = list(model.switchable_modules())
            news = [sub._modules.pop("new") for sub in subs]
            try:
                teacher = copy.deepcopy(model)
            finally:
                for sub, new in zip(subs, news):
                    sub._modules["new"] = new
        for sub in teacher.switchable_modules():
            sub.switch_old(remove_new=True)
            sub.capture = True
        for path, m in list(teacher.named_modules()):
            if isinstance(m, (QATConv2d, QATLinear)):
                set_submodule(teacher, path, m.dense())
        teacher = teacher.eval().requires_grad_(False)
        return cast_floating(teacher, torch.bfloat16) if self.amp else teacher

    def _bf16_params(self, model) -> dict:
        """bf16 copies of ``model``'s parameters for the sym teacher under amp,
        overwritten in place each call (a version bump per copy)."""
        if self._bf16 is None:
            self._bf16 = {n: torch.empty_like(p, dtype=torch.bfloat16)
                          for n, p in cast_params(model).items()}
        params = dict(model.named_parameters())
        for n, t in self._bf16.items():
            t.copy_(params[n])
        return self._bf16

    def student_forward(self, model, images):
        """The student's training forward: ``model(images)``, or under amp its
        forward on bf16 casts of its parameters and of the images."""
        if not self.amp:
            return model(images)
        return torch.func.functional_call(model, cast_params(model),
                                          (images.to(torch.bfloat16),))

    @torch.no_grad()
    def teacher_pass(self, images, model=None, teacher=None):
        """``(logits, taps)`` of the teacher on ``images``, in ``eval()`` under
        ``torch.no_grad()``: the asym teacher, or the student forced down its
        ``old`` branches (before the student's forward, so on the BatchNorm
        state from before the step)."""
        model = model if model is not None else self.runner.model
        teacher = teacher if teacher is not None else self.teacher
        if self.amp:
            images = images.to(torch.bfloat16)
        if self.asym:
            logits = teacher(images)
            return logits.float(), taps(teacher)
        was_training = model.training
        model.eval()
        try:
            with forced_branch(model, "old"):
                if self.amp:
                    logits = torch.func.functional_call(model, self._bf16_params(model),
                                                        (images,))
                else:
                    logits = model(images)
            return logits.float(), taps(model)
        finally:
            model.train(was_training)

    # -- the step --------------------------------------------------------
    def loss(self, images, labels, model=None, teacher=None):
        """``(loss, ce, norm)`` of one training step on a batch, with autograd
        (the JAX step's ``loss_fn``); ``model``/``teacher`` default to the
        runner's model and the hook's teacher."""
        model = model if model is not None else self.runner.model
        t_logits = t_taps = None
        if self.need_teacher:
            t_logits, t_taps = self.teacher_pass(images, model, teacher)
        model.train()
        logits = self.student_forward(model, images).float()
        ce = self._ce_fn()(logits, labels)
        total_norm = logits.new_zeros(())
        if not self.no_norm:
            s_taps = taps(model)
            keys = [f"{n}.out" for n in model.switchable_names]
            norm_vec = logits.new_zeros(images.shape[0])
            for key in keys:
                diff = s_taps[key].float() - t_taps[key].float()
                norm_vec = norm_vec + torch.linalg.vector_norm(diff.flatten(1), dim=1)
            total_norm = (norm_vec / len(keys)).mean()
        loss = self.l2_weight * total_norm + self.cls_weight * ce
        if self.kd_weight > 0:
            T = float(self.kd_temperature)
            # over the class axis: dim 1 of (B, K) and of NCHW segmentation logits
            t_log, s_log = t_logits / T, logits / T
            kd = (F.softmax(t_log, 1) * (F.log_softmax(t_log, 1) - F.log_softmax(s_log, 1))
                  ).sum(1).mean()
            loss = loss + self.kd_weight * T ** 2 * kd
        return loss, ce, total_norm

    def train_step(self, images, labels, mask: Set[str]):
        """One training step: the loss, its backward and the masked update;
        ``(loss, ce, norm)`` of this rank's rows, detached.  Across processes
        the forward and backward run on the data axis (``nn.sharded_batch``)
        and the update averages the gradients over it."""
        self.optimizer.zero_grad()
        with sharded_batch(self.shard):
            loss, ce, norm = self.loss(images, labels)
            loss.backward()
        self.optimizer.step(mask)
        release_taps(self.runner.model)
        if self.teacher is not None:
            release_taps(self.teacher)
        return loss.detach(), ce.detach(), norm.detach()

    def trainable(self, behavior: int) -> Set[str]:
        """The parameters an epoch of ``behavior`` trains: layer ``behavior``'s
        (>= 0), every switchable layer's (-1) or all (-2); never an ``old``
        branch."""
        model = self.runner.model
        if behavior >= 0:
            mask = model.freeze_except(behavior)
        elif behavior == -1:
            mask = model.freeze_except(*range(model.length_switchable))
        else:
            mask = model.unfreeze()
        olds = tuple(f"{n}.old." for n in model.switchable_names)
        return {n for n in mask if not n.startswith(olds)}

    # -- main entry ------------------------------------------------------
    def after_optimize(self):
        logger = get_logger()
        runner = self.runner
        model = runner.model
        self._refuse_spatial(model)
        device = runner.device
        # across processes: each rank steps on its rows of every global batch, from the
        # first rank's weights; with a model axis, its ranks load the same rows
        other = self.other_args
        mp = int(other.model_parallel or 1)
        mesh = training_mesh(other.use_mesh, mp, "model_parallel") if mp > 1 else None
        if mp > 1 and mesh is None:
            logger.warning(f"model_parallel={mp}: one process (or use_mesh off): trained "
                           f"unsharded")
        self.shard = shard = training_axis(other.use_mesh, mesh)
        replicate_from_root(model, shard, mesh)
        if runner.model_before_passes is not None:
            replicate_from_root(runner.model_before_passes, shard, mesh)
        if shard is not None:
            logger.info(f"training over a data axis of {shard.count} ranks")

        # the student routes (and, in asym mode or with no teacher signal,
        # prunes) to the new branch; sym keeps the old one as the teacher
        if self.asym and self.need_teacher:
            self.teacher = self._build_teacher()
        for sub in model.switchable_modules():
            sub.switch_new(remove_old=self.asym or not self.need_teacher)
            sub.capture = not self.no_norm

        image_size = tuple(self.data_config.image_size)
        num_classes = self.other_args.num_classes
        if self.dataset_args.dataset:
            ds_train = build_dataset(dict(self.dataset_args.dataset), split="train")
            ds_eval = build_dataset(dict(self.dataset_args.dataset), split="validation")
            num_classes = getattr(ds_train, "num_classes", num_classes)
        else:
            ds_train, ds_eval = self._default_datasets(image_size, num_classes)

        def mk_loader(ds, shuffle, aug=None):
            return Loader(ds, self.dataset_args.batch_size, shuffle=shuffle, drop_last=True,
                          mean=self.data_config.mean, std=self.data_config.std,
                          image_size=image_size, device=device, aug=aug,
                          sharding=shard and (shard.index, shard.count))

        loader_train = mk_loader(ds_train, True, self.data_config.aug)
        loader_eval = mk_loader(ds_eval, False)
        steps_per_epoch = len(loader_train)
        if self.other_args.max_steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, self.other_args.max_steps_per_epoch)

        self.optimizer, lr_sched = make_optimizer(model.named_parameters(), self.optim_args,
                                                  self.sche_args, steps_per_epoch, data=shard)
        start_epoch = self._resume() if self.other_args.resume else 0
        if self.other_args.start_epoch is not None:
            start_epoch = self.other_args.start_epoch
        if mesh is not None:  # the student keeps its shards; the teacher stays whole
            self._enable_tp(mesh, mp, steps_per_epoch)

        num_epochs = self.sche_args.epochs
        behavior = list(self.epoch_behavior)
        behavior += [-1] * max(0, num_epochs - len(behavior))
        behavior = behavior[:num_epochs]
        logger.info(f"epoch behaviors: {behavior}")

        eval_metric = self.other_args.eval_metric
        out_dir = runner.cfg.work_dir or "."
        saver = None
        # a sharded save is collective: every rank builds the saver (npz: the first only)
        if get_rank() == 0 or self.other_args.ckpt_backend == "sharded":
            saver = CheckpointSaver(out_dir, decreasing=(eval_metric == "loss"),
                                    max_history=self.other_args.checkpoint_hist,
                                    backend=self.other_args.ckpt_backend)

        seed = int(runner.cfg.seed or 0)
        generator = torch.Generator(device=device)
        best_metric = best_epoch = None
        preempted = False
        epoch = start_epoch
        step_count = start_epoch * steps_per_epoch
        guard = PreemptionGuard()
        guard.__enter__()  # SIGTERM -> a cooperative stop and checkpoint
        self._guard = guard
        try:
            with drop_generator(model, generator):
                for epoch in range(start_epoch, num_epochs):
                    mask = self.trainable(behavior[epoch])
                    loader_train.set_epoch(epoch)
                    train_metrics, step_count = self._train_one_epoch(
                        epoch, loader_train, steps_per_epoch, mask, step_count, lr_sched,
                        generator, seed)
                    eval_metrics = self._validate(loader_eval)
                    if get_rank() == 0:
                        update_summary(epoch, train_metrics, eval_metrics,
                                       os.path.join(out_dir, "summary.csv"),
                                       write_header=best_metric is None)
                    if saver is not None or self.tp is not None:
                        variables, opt = self._checkpoint()
                        if saver is not None:
                            best_metric, best_epoch = saver.save_checkpoint(
                                variables, epoch, eval_metrics[eval_metric], opt_state=opt)
        except KeyboardInterrupt:
            pass
        except Preempted:
            preempted = True
            if saver is not None or self.tp is not None:
                variables, opt = self._checkpoint()
            if saver is not None:
                path = saver.save_last(variables, epoch - 1, opt_state=opt)
                logger.warning(f"preempted during epoch {epoch}: full train state saved to "
                               f"{path}; resuming will redo epoch {epoch}")
        finally:
            self._guard = None
            guard.__exit__()
            release_taps(model)
            model.eval()
            if saver is not None:
                saver.wait()  # the last asynchronous save commits before the hook returns
        if self.tp is not None:  # the whole trained student on every rank
            unshard_module(model)
            self.tp = None
        if best_metric is not None:
            logger.info(f"*** Best metric: {best_metric} (epoch {best_epoch})")
        self.result = dict(best_metric=best_metric, best_epoch=best_epoch, preempted=preempted)

    def _enable_tp(self, mesh, mp: int, steps_per_epoch: int):
        """Shard the student over ``mesh``'s model axis and rebuild the
        optimizer over its shards, with the rank's slices of the state it had."""
        model = self.runner.model
        shard_module(model, mesh, mp, self.other_args.tp_rules)
        self.tp = plan = tp_plan(model)
        old = self.optimizer
        self.optimizer, _ = make_optimizer(model.named_parameters(), self.optim_args,
                                           self.sche_args, steps_per_epoch, data=self.shard,
                                           pipe=pipe_axis(mesh, plan.dims, plan.dims))
        carry_state(old, self.optimizer, plan)
        get_logger().info(summary(model))

    def _checkpoint(self):
        """``(variables, optimizer state)`` of a checkpoint: the whole student and
        optimizer state, gathered over the model group when it is sharded
        (collective then)."""
        model = self.runner.model
        if self.tp is None:
            return variables_of(model), self.optimizer
        tree = unflatten_tree(params_to_jax(gather_tensors(model.state_dict(), self.tp)))
        return tree, gathered_opt_state(self.optimizer, self.tp)

    def _resume(self) -> int:
        """Load ``other_args.resume`` into the model and the optimizer; the epoch to start from."""
        logger = get_logger()
        path = self.other_args.resume
        flat = load_flat(path)
        load_jax_flat(self.runner.model, flat)
        ckpt = unflatten_tree(flat)
        restored = []
        start_epoch = 0
        if "opt" in ckpt:
            opt = ckpt["opt"]
            if (opt_state_from_tree(opt, self.optimizer) is None
                    and opt_state_from_jax(opt, self.optimizer) is None):
                logger.warning("resume: optimizer state structure mismatch; "
                               "keeping a fresh optimizer")
            else:
                restored.append("optimizer")
        if "meta" in ckpt and "epoch" in ckpt["meta"]:
            start_epoch = int(ckpt["meta"]["epoch"]) + 1
            restored.append(f"epoch {start_epoch}")
        logger.info(f"resumed weights from {path}"
                    + (f" (+ {', '.join(restored)})" if restored else ""))
        return start_epoch

    # -- task plug points (SegL2Reconstruct overrides these) ----------------
    def _ce_fn(self) -> Callable:
        """The task loss on (logits, labels): classification cross-entropy."""
        return F.cross_entropy

    def _default_datasets(self, image_size, num_classes):
        """Synthetic data when no dataset cfg is given."""
        return (Synthetic(256, image_size + (3,), num_classes, split="train"),
                Synthetic(128, image_size + (3,), num_classes, split="validation"))

    def _train_one_epoch(self, epoch, loader, steps, mask, step_count, lr_sched, generator,
                         seed):
        logger = get_logger()
        losses_m, norm_m, total_m, time_m = (AverageMeter() for _ in range(4))
        end = time.time()
        guard = self._guard
        shard = self.shard
        for i, (images, labels) in enumerate(loader):
            if i >= steps:
                break
            if guard is not None and guard.stop_requested(shard):
                raise Preempted()
            generator.manual_seed(step_seed(seed, step_count))
            loss, ce, norm = self.train_step(images, labels, mask)
            step_count += 1
            bs = images.shape[0]
            if i % self.other_args.log_interval == 0 or i == steps - 1:
                # the global batch's means: every rank holds as many rows
                ce, norm, loss, bs = sum_over([float(ce) * bs, float(norm) * bs,
                                               float(loss) * bs, bs], shard, images.device)
                ce, norm, loss = ce / bs, norm / bs, loss / bs
                losses_m.update(ce, bs)
                norm_m.update(norm, bs)
                total_m.update(loss, bs)
                time_m.update(time.time() - end)
                logger.info(
                    f"Train: {epoch} [{i:>4d}/{steps}]  "
                    f"Loss: {losses_m.val:#.4g} ({losses_m.avg:#.3g})  "
                    f"Norm: {norm_m.val:#.4g} ({norm_m.avg:#.3g})  "
                    f"Time: {time_m.val:.3f}s, {bs / max(time_m.val, 1e-9):>7.2f}/s  "
                    f"LR: {lr_sched(step_count):.3e}")
            end = time.time()
        return dict(loss=total_m.avg, norm=norm_m.avg), step_count

    def _validate(self, loader) -> Dict[str, float]:
        """Loss, top-1 and top-5 over the validation batches (``eval_metric``
        names one of them); across processes each batch's sums go over the
        data axis."""
        logger = get_logger()
        model = self.runner.model
        losses_m, top1_m, top5_m = (AverageMeter() for _ in range(3))
        max_batches = self.other_args.max_eval_batches
        model.eval()
        for i, (images, labels) in enumerate(loader):
            if max_batches and i >= max_batches:
                break
            loss, c1, c5, _ = eval_batch(model, images, labels)
            bs = images.shape[0]
            if self.shard is not None:
                loss, c1, c5, bs = sum_over([float(loss) * bs, float(c1), float(c5), bs],
                                            self.shard, images.device)
                loss, bs = loss / bs, int(bs)
            losses_m.update(float(loss), bs)
            top1_m.update(float(c1) / bs * 100.0, bs)
            top5_m.update(float(c5) / bs * 100.0, bs)
        metrics = dict(loss=losses_m.avg, top1=top1_m.avg, top5=top5_m.avg)
        logger.info(f"Eval: {metrics}")
        return metrics
