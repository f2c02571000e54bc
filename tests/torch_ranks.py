"""Ranks of a gloo process group on the CPU, for the port's tests across
processes (``tests/test_torch_parallel_*.py``, ``tests/test_torch_serve_cli.py``).

:func:`spawn` starts ``world`` processes, each joins the group through a
file store under the test's temporary directory, runs one job of this module
with one thread, and saves what it returns; the parent gets every rank's
result.  This module imports no JAX, so the ranks start quickly: the tests
hold the ranks' results against the JAX package in the parent process.
"""

import copy
import datetime
import functools
import logging
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a hung collective fails the rank (and the test) after this, not gloo's 30 minutes
TIMEOUT = datetime.timedelta(seconds=120)
TINY_MSCAN = dict(num_channels=(8, 16, 24, 32), num_blocks=(2, 2, 4, 2),
                  exp_ratios=(2, 2, 2, 2), num_classes=16)
TINY_CONVNEXT = dict(depths=(2, 2, 4, 2), dims=(8, 16, 24, 32), num_classes=16)


def _entry(rank, world, init, job, out_dir, kwargs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    try:
        result = job(**kwargs)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(job, world: int, tmp_dir, **kwargs) -> list:
    """Every rank's result of ``job(**kwargs)`` across ``world`` gloo ranks."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    mp.spawn(_entry, args=(world, f"file://{tmp_dir}/store", job, tmp_dir, kwargs),
             nprocs=world, join=True)
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- models ------------------------------------------------------------------
def build(name: str):
    from convnet_approximater_tpu_torch.models import ConvNeXt, MSCAN_Classifier, ResNet

    return {"mscan": lambda: MSCAN_Classifier(**TINY_MSCAN),
            "convnext": lambda: ConvNeXt(**TINY_CONVNEXT),
            "resnet": lambda: ResNet(18, 10)}[name]()


def randomized(name: str, seed: int):
    """A tiny model with random weights, layer scales 1 (ConvNeXt's 1e-6 would
    hide its blocks) and norm statistics of order 1, in eval mode."""
    return randomize(build(name), seed)


def randomize(model, seed: int):
    """:func:`randomized`'s weights for ``model``."""
    from convnet_approximater_tpu_torch.nn import channels_last, init_weights

    init_weights(model, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if "layer_scale" in key or key.endswith("gamma"):
                t.fill_(1.0)
            elif key.endswith("running_var"):
                t.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif key.endswith("running_mean"):
                t.copy_(torch.from_numpy((0.3 * rs.randn(*t.shape)).astype(np.float32)))
    return channels_last(model).eval()


@functools.lru_cache(maxsize=None)
def _state(path: str) -> dict:
    from convnet_approximater_tpu_torch.convert import params_from_jax
    from convnet_approximater_tpu_torch.utils import load_flat

    return params_from_jax(load_flat(path))


def load(name: str, path: str):
    """The model of ``name`` with the weights of the flat npz at ``path``."""
    from convnet_approximater_tpu_torch.nn import channels_last

    model = build(name)
    model.load_state_dict(_state(path))
    return channels_last(model).eval()


def split_forward(model, carrier, x, M: int, stages):
    """``model(x)`` with each of the carrier's ``stages`` run on the M
    microbatches in turn: the plain forward on a pipeline's split."""
    carrier._exec_stage = lambda s, stage, h: (torch.cat([stage(c) for c in h.chunk(M)])
                                                if s in stages else stage(h))
    try:
        return model(x)
    finally:
        del carrier._exec_stage


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def device_bytes(module) -> int:
    """Bytes of ``module``'s parameters that hold memory (not released)."""
    return sum(p.numel() * p.element_size() for p in module.parameters() if not p.is_meta)


class Records(logging.Handler):
    """Keeps the messages of the port's logger (rank 0's)."""

    def __init__(self):
        super().__init__()
        self.messages = []
        logger = logging.getLogger("convnet_approximater_tpu_torch")
        logger.setLevel(logging.INFO)
        logger.addHandler(self)

    def emit(self, record):
        self.messages.append(record.getMessage())


# -- jobs --------------------------------------------------------------------
def pipeline_job(npz: dict, x: np.ndarray, blocks_x: np.ndarray, ci: dict = None,
                 eval_cfg: dict = None):
    """On a (1, world) mesh: ``pipeline_blocks`` against the blocks in sequence
    and its errors; the whole-model pipeline and the in-stage pipelines against
    the plain forward; the ownership of weights; given ``eval_cfg``,
    ``ValidateHelper(use_mesh=True)`` on a tiny MSCAN stage-pipelined over a
    (world // 2, 2) mesh; ``ClassInference``'s wiring and, given ``ci`` (a
    config, its checkpoint, a work dir and an ``eval_cfg``), its pipelined
    reports in both modes."""
    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.classification.validate import ValidateHelper
    from convnet_approximater_tpu_torch.models.stage_exec import resolve_pipeline_carrier
    from convnet_approximater_tpu_torch.runner import class_inference

    n = dist.get_world_size()
    mesh = parallel.make_mesh(data=1, model=n)
    out = {"blocks": {}, "errors": {}, "whole": {}, "stage": {}}
    xt, ht = nchw(x), nchw(blocks_x)
    with torch.no_grad():
        # pipeline_blocks: stage 2 of the tiny MSCAN (4 identical blocks)
        mscan = load("mscan", npz["mscan"])
        blocks = list(mscan.backbone.layers[2][1])
        seq = ht
        for b in blocks:
            seq = b(seq)
        for M in (n, 2 * n):
            out["blocks"][M] = (parallel.pipeline_blocks(blocks, ht, mesh, num_microbatches=M),
                                seq)
        for label, args in (("ragged", (blocks[:1] + list(mscan.backbone.layers[1][1])[:1], ht)),
                            ("split", (blocks + blocks[:1], ht)),
                            ("microbatches", (blocks, ht[:n + 1]))):
            try:
                parallel.pipeline_blocks(*args, mesh, num_microbatches=n)
            except ValueError as e:
                out["errors"][label] = str(e)
        for name in ("mscan", "convnext", "resnet"):
            model = load(name, npz[name])
            plain = model(xt)
            split = torch.cat([model(c) for c in xt.chunk(2 * n)])
            forward, report = parallel.build_model_pipeline(model, x.shape, mesh,
                                                            num_microbatches=2 * n)
            owned = device_bytes(model)
            y = forward(xt)
            forward.close()
            out["whole"][name] = dict(y=y, plain=plain, split=split, report=report,
                                      owned=owned, total=device_bytes(model),
                                      after=model(xt))
        for name in ("mscan", "convnext"):
            model = load(name, npz[name])
            plain = model(xt)
            carrier = resolve_pipeline_carrier(model)
            stages = carrier.pipeline_stages()
            total = [device_bytes(s) for s in stages]
            carrier.enable_pipeline(mesh, num_microbatches=2 * n)
            owned = [device_bytes(s) for s in stages]
            y = model(xt)
            pipelined = carrier.pipelined_stages()
            carrier.enable_pipeline(None)
            split = split_forward(model, carrier, xt, 2 * n, pipelined)
            out["stage"][name] = dict(y=y, plain=plain, split=split, stages=pipelined,
                                      owned=owned, total=total, after=model(xt),
                                      restored=[device_bytes(s) for s in stages])
    # data-parallel validation of a model pipelined on a (n // 2, 2) mesh: the pipe
    # ranks of a data group load the same rows, the sums go over the data axis
    if eval_cfg is not None:
        model = load("mscan", npz["mscan"])
        resolve_pipeline_carrier(model).enable_pipeline(parallel.make_mesh(data=n // 2, model=2))
        out["validate"] = ValidateHelper(model, dict(eval_cfg, use_mesh=True),
                                         device="cpu").validate()
    # ClassInference: the wiring, then each mode's reports on a tiny config
    records = Records()
    out["wired"] = [class_inference.enable_stage_pipeline(load(name, npz[name]), mesh)
                    for name in ("mscan", "convnext", "resnet")]
    try:
        class_inference.pipeline_mesh(n + 1)
    except ValueError as e:
        out["errors"]["pipeline_parallel"] = str(e)
    if ci is None:
        out["log"] = records.messages
        return out
    from convnet_approximater_tpu_torch.utils import init_cfg, update_cfg

    init_cfg(ci["cfg"])
    update_cfg(work_dir=ci["work_dir"], checkpoint=ci["ckpt"], seed=0)
    out["reports"] = {mode: class_inference.ClassInference(
        ci["ckpt"], batch_size=2 * n, input_size=(32, 32, 3), device="cpu",
        pipeline_parallel=n, pipeline_mode=mode, eval_cfg=ci.get("eval_cfg")).run()
        for mode in ("stage", "whole")}
    out["log"] = records.messages
    return out


def serve_job(argv: list) -> dict:
    """``serve.main(argv)`` on this rank: the last batch's logits and what it served."""
    from convnet_approximater_tpu_torch import serve

    res = serve.main(argv)
    return {k: res[k] for k in ("logits", "served", "min_batch", "world", "batch", "rows")}


def serving_job(eval_cfg: dict, seed: int, serve_argvs: dict) -> dict:
    """The data-axis helpers of ``parallel`` on a (world, 1) mesh, then
    ``ValidateHelper(use_mesh=True)`` on a tiny MSCAN and ``serve
    --data-parallel`` of each of ``serve_argvs``."""
    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.classification.validate import ValidateHelper

    rank = dist.get_rank()
    mesh = parallel.make_mesh()
    rows = torch.arange(24.0).reshape(6, 4)
    padded, valid = parallel.pad_to_multiple(rows[:5], 4)
    replica = randomized("resnet", rank)  # each rank's own weights, until replicate
    parallel.replicate(replica, mesh)
    model = randomized("mscan", seed)
    return dict(
        mesh=dict(sharding=parallel.batch_sharding(mesh), shard=parallel.shard_batch(rows, mesh),
                  padded=padded, valid=valid, main=parallel.is_main_process(),
                  count=parallel.process_count(), replica=replica.state_dict()),
        validate=ValidateHelper(model, dict(eval_cfg, use_mesh=True), device="cpu").validate(),
        serve={k: serve_job(argv) for k, argv in serve_argvs.items()})


# -- data-parallel training (tests/test_torch_data_parallel_*.py) -------------
def _register_training_pieces():
    """The port's TinyBNNet (TinyNet with a BatchNorm after each conv, the JAX
    twin in ``tests/test_torch_data_parallel_training.py``) and a hook that
    loads a flat npz into the runner's model after Optimize."""
    from convnet_approximater_tpu_torch import nn as tnn
    from convnet_approximater_tpu_torch.convert import params_from_jax
    from convnet_approximater_tpu_torch.hooks import HOOK, Hook
    from convnet_approximater_tpu_torch.models import MODEL, SwitchableModel
    from convnet_approximater_tpu_torch.utils import load_flat

    if "TinyBNNet" not in MODEL:

        @MODEL.register_module()
        class TinyBNNet(SwitchableModel):
            def __init__(self, num_classes=4, init_cfg=None):
                super().__init__(init_cfg=init_cfg)
                self.features = torch.nn.Sequential(
                    tnn.Conv2d(3, 8, 3, padding=1), tnn.BatchNorm2d(8), tnn.ReLU(),
                    tnn.MaxPool2d(2, 2),
                    tnn.Conv2d(8, 12, 3, padding=1), tnn.BatchNorm2d(12), tnn.ReLU(),
                    tnn.Conv2d(12, 12, 3, padding=1), tnn.BatchNorm2d(12), tnn.ReLU())
                self.head = tnn.Linear(12, num_classes)

            def forward(self, x):
                return self.head(self.features(x).mean(dim=(2, 3)))

    if "LoadFlat" not in HOOK:

        @HOOK.register_module()
        class LoadFlat(Hook):
            """Loads the flat npz at ``path`` into the model before fine-tuning."""

            def __init__(self, runner, priority, path):
                super().__init__(runner, priority)
                self.path = path

            def after_optimize(self):
                state = params_from_jax(load_flat(self.path))
                missing, unexpected = self.runner.model.load_state_dict(state, strict=False)
                assert not missing and not unexpected, (missing, unexpected)


_register_training_pieces()


def tiny_mscan_drop(seed: int):
    """The tiny MSCAN with drop path 0.2 and dropout 0.1, random weights from ``seed``."""
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier
    from convnet_approximater_tpu_torch.nn import init_weights

    model = MSCAN_Classifier(**TINY_MSCAN, drop_rate=0.1, drop_path_rate=0.2)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def tiny_bn_net(path: str):
    """TinyBNNet with the weights of the flat npz at ``path``."""
    from convnet_approximater_tpu_torch.convert import params_from_jax
    from convnet_approximater_tpu_torch.models import build_model
    from convnet_approximater_tpu_torch.utils import load_flat

    model = build_model(dict(type="TinyBNNet", num_classes=4))
    model.load_state_dict(params_from_jax(load_flat(path)))
    return model


def loader_batches(case: dict, sharding=None) -> list:
    """Two epochs of a shuffled ``Loader`` with augmentation ``case`` over a
    small Synthetic pool, global batch 16: per batch the normalised images,
    the labels and the uint8 rows ``gather`` gives."""
    from convnet_approximater_tpu_torch.data import Loader, Synthetic

    loader = Loader(Synthetic(48, (12, 13, 3), 4, seed=1), 16, shuffle=True, seed=3,
                    device="cpu", prefetch=0, sharding=sharding, **case)
    out = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        order = loader._indices()
        for i, (x, y) in enumerate(loader):
            out.append(dict(x=x, y=y, u8=loader.gather(order[i * 16:(i + 1) * 16])[0]))
    return out


def pieces_job(bn: dict, loader_cases: dict, mix: dict, trees: dict) -> dict:
    """On a (world, 1) mesh: ``BatchNorm2d`` forward and backward on this rank's
    rows of ``bn["x"]`` inside ``sharded_batch``; the sharded ``Loader`` with
    each augmentation case, through the native prep and numpy; ``apply_mix``
    of each draw on this rank's rows; ``save_sharded`` of ``trees["tree"]``
    across the ranks into ``trees["two"]`` and ``restore_sharded`` of the
    one-process checkpoint ``trees["one"]``; a pipelined stage in training
    over a (1, world) mesh beside the plain training step."""
    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.data.mixup import apply_mix
    from convnet_approximater_tpu_torch.models.stage_exec import resolve_pipeline_carrier
    from convnet_approximater_tpu_torch.nn import BatchNorm2d, sharded_batch
    from convnet_approximater_tpu_torch.utils.sharded_ckpt import (checkpoint_group,
                                                                   restore_sharded, save_sharded)

    shard = parallel.training_axis(True)
    sharding = (shard.index, shard.count)
    rows = parallel.shard_rows(len(bn["x"]), sharding)
    out = {"shard": tuple(shard[:2])}
    norm = BatchNorm2d(bn["x"].shape[-1])
    norm.load_state_dict(bn["state"])
    x = nchw(bn["x"][rows]).requires_grad_()
    with sharded_batch(shard):
        y = norm.train()(x)
    (y * nchw(bn["dy"][rows])).sum().backward()
    out["bn"] = dict(y=y.detach(), dx=x.grad, dw=norm.weight.grad, db=norm.bias.grad,
                     mean=norm.running_mean, var=norm.running_var)
    out["loaders"] = {(name, native): loader_batches(dict(case, native=native), sharding)
                      for name, case in loader_cases.items() for native in (True, False)}
    out["mix"] = [apply_mix(draw, mix["images"][rows], mix["targets"][rows], shard)
                  for draw in mix["draws"]]
    save_sharded(trees["two"], trees["tree"], wait=True, group=checkpoint_group())
    out["restored"] = restore_sharded(trees["one"])
    # a pipelined stage in training, against the plain training step on the same process
    model = randomized("mscan", 0).train()
    plain = copy.deepcopy(model)
    x = nchw(np.random.RandomState(3).randn(4, 32, 32, 3).astype(np.float32))
    y_plain = plain(x)
    y_plain.square().mean().backward()
    resolve_pipeline_carrier(model).enable_pipeline(parallel.make_mesh(data=1, model=shard.count),
                                                    num_microbatches=1)
    y = model(x)
    y.square().mean().backward()
    grads = dict(plain.named_parameters())
    out["pipelined_training"] = dict(
        y=y.detach(), plain=y_plain.detach(),
        grads={n: (p.grad, grads[n].grad) for n, p in model.named_parameters() if not p.is_meta})
    return out


class TriggerOnRank(object):
    """A preemption guard whose notice arrives on rank ``rank`` when the train
    loop reads it for the ``at``-th time."""

    rank, at = 1, 3

    def __new__(cls):
        from convnet_approximater_tpu_torch.utils.preempt import PreemptionGuard

        class Guard(PreemptionGuard):
            reads = 0

            @property
            def triggered(self):
                self.reads += 1
                if dist.get_rank() == cls.rank and self.reads == cls.at:
                    self.trigger()
                return super().triggered

        return Guard()


def recorded(helper_or_hook) -> list:
    """Each call's result of ``train_step``, detached, in a list."""
    steps, step = [], helper_or_hook.train_step

    def wrapped(*args, **kwargs):
        out = step(*args, **kwargs)
        steps.append(out)
        return out

    helper_or_hook.train_step = wrapped
    return steps


def helper_run(model, cfg: dict) -> dict:
    """``TrainHelper(model, cfg).train()`` on the CPU: the weights, the EMA, the
    optimizer state and each step's loss of this rank's rows."""
    from convnet_approximater_tpu_torch.classification import TrainHelper
    from convnet_approximater_tpu_torch.hooks.finetune import opt_state_to_tree

    helper = TrainHelper(model, cfg, device="cpu")
    steps = recorded(helper)
    result = helper.train()
    return dict(state=helper.model.state_dict(), steps=[float(s) for s in steps],
                params=[n for n, _ in helper.model.named_parameters()],
                ema=helper.ema.state_dict() if helper.ema is not None else None,
                opt=opt_state_to_tree(helper.optimizer), best=result["best_metric"])


def l2_run(cfg_path: str, work_dir: str) -> dict:
    """The port's Runner on the fine-tune config at ``cfg_path`` (its
    L2Reconstruct hook), seed 0: the weights after the run and as the hook
    left them (``trained``), and each step's (loss, ce, norm) of this rank's rows."""
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    tcfg.init_cfg(cfg_path)
    tcfg.update_cfg(work_dir=work_dir, config_name="l2", seed=0)
    runner = Runner(device="cpu")
    hook = next(h for h in runner.hooks if h.name == "L2Reconstruct")
    steps, trained, after_optimize = recorded(hook), {}, hook.after_optimize

    def keeping():
        after_optimize()
        trained.update({k: v.clone() for k, v in runner.model.state_dict().items()})

    hook.after_optimize = keeping
    runner.run()
    return dict(state=runner.model.state_dict(), trained=trained, result=hook.result,
                steps=[[float(v) for v in s] for s in steps])


def training_job(l2: dict, mixed: dict, plain: dict, preempt: dict) -> dict:
    """Training across the ranks: the L2Reconstruct config ``l2["cfg"]``
    (its sharded checkpoints in the shared ``l2["work"]``); ``TrainHelper`` on
    the tiny MSCAN with drop path and dropout, each rank from its own random
    weights (``replicate`` gives it the first rank's), under ``mixed["cfg"]``;
    on TinyBNNet from ``plain["weights"]`` under ``plain["cfg"]``; and a
    TinyBNNet run whose guard raises a notice on rank 1 alone, each rank with
    its own npz work dir."""
    from convnet_approximater_tpu_torch.classification import train as train_mod

    rank = dist.get_rank()
    out = dict(l2=l2_run(l2["cfg"], l2["work"]),
               mixed=helper_run(tiny_mscan_drop(mixed["seed"] + rank), mixed["cfg"]),
               plain=helper_run(tiny_bn_net(plain["weights"]), plain["cfg"]))
    work = os.path.join(preempt["work"], f"rank{rank}")
    guard = train_mod.PreemptionGuard
    train_mod.PreemptionGuard = TriggerOnRank
    try:
        out["preempt"] = helper_run(tiny_bn_net(plain["weights"]),
                                    dict(preempt["cfg"], work_dir=work))
    finally:
        train_mod.PreemptionGuard = guard
    out["preempt"]["files"] = sorted(os.listdir(work)) if os.path.isdir(work) else None
    return out


# -- pipelined training (tests/test_torch_pipeline_training.py) ---------------
PP_MSCAN = dict(num_channels=(8, 16, 24, 32), num_blocks=(1, 1, 4, 2), exp_ratios=(2, 2, 2, 2),
                num_classes=16)
PP_CONVNEXT = dict(depths=(1, 1, 4, 1), dims=(8, 16, 24, 32), num_classes=16)
PP_HELPER_MSCAN = dict(num_channels=(8, 12, 16, 20), num_blocks=(1, 1, 4, 1),
                       exp_ratios=(2, 2, 2, 2), num_classes=4)


def from_flat(kind: str, spec: dict, path: str):
    """A port ``MSCAN_Classifier`` or ``ConvNeXt`` of ``spec`` with the weights of
    the flat npz at ``path``."""
    from convnet_approximater_tpu_torch.models import ConvNeXt, MSCAN_Classifier
    from convnet_approximater_tpu_torch.nn import channels_last

    model = (MSCAN_Classifier if kind == "mscan" else ConvNeXt)(**spec)
    model.load_state_dict(_state(path))
    return channels_last(model)


def pipe_step(model, x: np.ndarray, labels, mesh, M: int, training: bool = True) -> dict:
    """One forward and backward through ``model``'s stages pipelined over
    ``mesh`` in ``M`` microbatches, on this rank's rows of the global batch
    ``x``: the cross-entropy with ``labels`` (None: the sum of the squared
    logits) of the global batch, each gradient present here (averaged over the
    data axis), the running statistics after it."""
    import torch.nn.functional as F

    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.models.stage_exec import resolve_pipeline_carrier
    from convnet_approximater_tpu_torch.nn import sharded_batch

    shard = parallel.training_axis(True, mesh)
    rows = parallel.shard_rows(len(x), (shard.index, shard.count) if shard else (0, 1))
    carrier = resolve_pipeline_carrier(model)
    carrier.enable_pipeline(mesh, num_microbatches=M)
    model.train(training)
    with sharded_batch(shard):
        logits = model(nchw(x[rows]))
        if labels is None:
            loss = (logits ** 2).sum()
        else:
            loss = F.cross_entropy(logits, torch.as_tensor(labels[rows]))
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if not p.is_meta}
    loss = float(loss)
    if shard is not None:
        parallel.average_gradients(list(grads.values()), shard)
        loss = parallel.sum_over([loss], shard, "cpu")[0] / shard.count
    return dict(loss=loss, grads=grads, stages=carrier.pipelined_stages(),
                state={k: v.clone() for k, v in model.state_dict().items()
                       if not v.is_meta and "running" in k})


def pipelined_run(model, cfg: dict) -> dict:
    """:func:`helper_run` with whether the stages ran pipelined, and the model's
    state and EMA after the gather (every rank holds the whole model)."""
    from convnet_approximater_tpu_torch.classification import train as train_mod

    stages, enable = [], train_mod.TrainHelper._enable_pipeline

    def keeping(helper, *args):
        enable(helper, *args)
        stages[:] = [c.pipelined_stages() for c in helper.carriers]

    train_mod.TrainHelper._enable_pipeline = keeping
    try:
        out = helper_run(model, cfg)
    finally:
        train_mod.TrainHelper._enable_pipeline = enable
    out["stages"] = stages
    return out


def pipe4_job(npz: dict, x: np.ndarray, labels: np.ndarray, helper: dict) -> dict:
    """On a (1, 4) mesh: a training step of the tiny MSCAN at M = 1 and M = 4,
    ConvNeXt's eval-mode gradients at M = 1, and ``TrainHelper(pipeline_parallel=4)``
    for one epoch, for two, and resumed from the first's checkpoint for the second."""
    from convnet_approximater_tpu_torch import parallel

    mesh = parallel.make_mesh(data=1, model=4)
    out = {f"step{M}": pipe_step(from_flat("mscan", PP_MSCAN, npz["mscan"]), x, labels, mesh, M)
           for M in (1, 4)}
    out["convnext"] = pipe_step(from_flat("convnext", PP_CONVNEXT, npz["convnext"]), x, None,
                                mesh, 1, training=False)
    for name, over in helper["runs"].items():
        out[name] = pipelined_run(from_flat("mscan", PP_HELPER_MSCAN, npz["helper"]),
                                  dict(helper["cfg"], **over))
    return out


def tiny_mscan(seed: int, drops: bool = False):
    """The tiny MSCAN with random weights from ``seed``; with ``drops``, drop
    path 0.2 and dropout 0.1 (:func:`tiny_mscan_drop`)."""
    from convnet_approximater_tpu_torch.models import MSCAN_Classifier
    from convnet_approximater_tpu_torch.nn import init_weights

    if drops:
        return tiny_mscan_drop(seed)
    model = MSCAN_Classifier(**TINY_MSCAN)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model


def dp2pp2_job(npz: dict, x: np.ndarray, labels: np.ndarray, runs: dict) -> dict:
    """On a (2, 2) mesh: a training step of the tiny MSCAN at M = 4 and M = 1,
    then each ``TrainHelper`` run of ``runs`` (name: ``(seed, drops, cfg)`` of
    :func:`tiny_mscan`); a run whose helper raises gives the message."""
    from convnet_approximater_tpu_torch import parallel

    mesh = parallel.make_mesh(data=2, model=2)
    out = {f"step{M}": pipe_step(from_flat("mscan", PP_MSCAN, npz["mscan"]), x, labels, mesh, M)
           for M in (4, 1)}
    for name, (seed, drops, cfg) in runs.items():
        try:
            out[name] = pipelined_run(tiny_mscan(seed, drops), cfg)
        except ValueError as e:
            out[name] = str(e)
    return out


def axis_one_run(model, cfg: dict, store: str) -> dict:
    """:func:`pipelined_run` in this process alone with the stage engine at
    axis size 1 (``TrainHelper`` pipelines only over several processes): the
    reference a pipelined run is held to at the same microbatches."""
    from unittest import mock

    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.classification import train as train_mod

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=1, rank=0,
                            timeout=TIMEOUT)
    try:
        with mock.patch.object(train_mod, "training_mesh",
                               lambda use_mesh, pp: parallel.make_mesh(data=1, model=1)):
            return pipelined_run(model, cfg)
    finally:
        dist.destroy_process_group()


# -- tensor parallelism (tests/test_torch_tensor_parallel.py) -----------------
TP_INPUT = {"mscan": (4, 32, 32), "convnext": (4, 32, 32), "resnet": (4, 32, 32),
            "vgg": (4, 32, 32), "alexnet": (4, 64, 64)}


def tp_build(name: str):
    """The port model of a tensor-parallel family (its preset has the same name)."""
    from convnet_approximater_tpu_torch.models import VGG, AlexNet, ResNet

    if name == "vgg":
        return VGG(depth=11, num_classes=16)
    if name == "alexnet":
        return AlexNet(num_classes=16)
    if name == "resnet":
        return ResNet(18, 16)
    return build(name)


def tp_model(name: str, path: str):
    """:func:`tp_build`'s model with the weights of the flat npz at ``path``, in eval mode."""
    from convnet_approximater_tpu_torch.nn import channels_last

    model = tp_build(name)
    model.load_state_dict(_state(path))
    return channels_last(model).eval()


def violation(got: torch.Tensor, want, rtol: float, atol: float) -> float:
    """``max |got - want| / (atol + rtol |want|)``: at most 1 where
    ``np.testing.assert_allclose(got, want, rtol, atol)`` passes."""
    got = got.detach().double().cpu().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want)), initial=0.0))


class Calls:
    """Counts the calls of ``module.attr`` (and keeps each call's argument shapes)."""

    def __init__(self, module, attr):
        self.module, self.attr, self.shapes = module, attr, []
        self.fn = getattr(module, attr)

        def counted(*args, **kwargs):
            self.shapes.append(tuple(tuple(a.shape) for a in args[:2]))
            return self.fn(*args, **kwargs)

        setattr(module, attr, counted)

    def close(self):
        setattr(self.module, self.attr, self.fn)


class Numels(Calls):
    """Keeps the element count of argument ``arg`` of each call of ``module.attr``."""

    def __init__(self, module, attr, arg: int):
        self.numels = []
        super().__init__(module, attr)
        fn = self.fn

        def counted(*args, **kwargs):
            self.numels.append(args[arg].numel())
            return fn(*args, **kwargs)

        setattr(module, attr, counted)


def tp_family(name: str, path: str, x: np.ndarray, labels: np.ndarray, want: str, mesh,
              tol: dict) -> dict:
    """One family sharded by its preset over ``mesh``: its eval forward on the
    rank's rows against the JAX logits, the gradients of the global batch's
    cross-entropy through the eval-mode module path (averaged over the data
    axis, gathered whole) against the JAX gradients (both in the npz at
    ``want``), and what the rank holds."""
    import torch.nn.functional as F

    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.convert import params_from_jax
    from convnet_approximater_tpu_torch.layers import MSCA
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.parallel import tp
    from convnet_approximater_tpu_torch.utils import load_flat

    shard = parallel.training_axis(True, mesh)
    rows = parallel.shard_rows(len(x), (shard.index, shard.count) if shard else (0, 1))
    model = tp_model(name, path)
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mp = parallel.mesh.axis_ranks(mesh, parallel.MODEL_AXIS)[1]
    tp.shard_module(model, mesh, mp, name)
    plan = tp.tp_plan(model)
    expect = load_flat(want)
    out = dict(sharded=sorted(plan.dims), roles={k: v.role for k, v in tp.layouts(model).items()})
    out["held"] = all(tuple(p.shape) == tuple(s // mp if i == plan.dims.get(n) else s
                                              for i, s in enumerate(whole[n]))
                      for n, p in model.named_parameters())
    out["bytes"] = (tp.shard_bytes(model)[0], sum(4 * int(np.prod(s)) for s in whole.values()))
    xt = nchw(x[rows])
    calls = Calls(fused_ops, "msca_fused")
    try:
        with torch.no_grad():
            y = model(xt)
    finally:
        calls.close()
    out["fused"] = (len(calls.shapes), sum(isinstance(m, MSCA) for m in model.modules()))
    out["y"] = violation(y, expect["logits"][rows], tol["y"], tol["y"])
    loss = F.cross_entropy(model(xt), torch.as_tensor(labels[rows]))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    if shard is not None:
        parallel.average_gradients(list(grads.values()), shard)
    want_g = params_from_jax({k[len("grads/"):]: v for k, v in expect.items()
                              if k.startswith("grads/")})
    # each rank holds its slice of a sharded gradient against the same slice of JAX's
    want_g = tp.slice_tensors(want_g, plan)
    out["grads"] = {n: violation(g, want_g[n].numpy(), tol["g_rtol"], tol["g_atol"])
                    for n, g in grads.items()}
    return out


def tp_dropout(mesh) -> dict:
    """AlexNet's classifier in training under the ``alexnet`` preset (its
    dropouts on the sharded hidden activation and on the replicated one)
    against the same forward whole, the drop generators seeded alike."""
    import copy as _copy

    from convnet_approximater_tpu_torch.layers import drop_generator
    from convnet_approximater_tpu_torch.models import AlexNet
    from convnet_approximater_tpu_torch.nn import init_weights
    from convnet_approximater_tpu_torch.parallel import tp

    model = AlexNet(num_classes=16)
    init_weights(model, torch.Generator().manual_seed(3))
    whole = _copy.deepcopy(model)
    tp.shard_module(model, mesh, 2, "alexnet")
    x = nchw(np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32))
    ys = []
    for m in (model.train(), whole.train()):
        gen = torch.Generator().manual_seed(11)
        with drop_generator(m, gen):
            ys.append(m(x).detach())
    return dict(y=ys[0], whole=ys[1], slices=[getattr(m, "tp_slice", None)
                                              for m in model.classifier])


def tp_explicit(mesh) -> dict:
    """The tiny MSCAN under rules no preset has: the first strip branch's and
    conv0's depthwise taps column-sharded (the kernel caches build from the
    gathered taps) and ``norm1``'s scale alone sharded (a gathered layer): its
    eval forward with autograd off (the fused kernel) and on (the module
    path) against the replicated model's, and the layer forms."""
    import copy as _copy

    from convnet_approximater_tpu_torch.parallel import tp

    model = randomized("mscan", 4)
    whole = _copy.deepcopy(model)
    rules = [("branches/0/conv1/weight", (None, None, None, "model")),
             ("conv0/weight", (None, None, None, "model")), ("conv0/bias", ("model",)),
             ("norm1/scale", ("model",))]
    tp.shard_module(model, mesh, 2, rules)
    x = nchw(np.random.RandomState(6).randn(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        fused, fused_ref = model(x), whole(x)
    return dict(fused=(fused, fused_ref), module=(model(x).detach(), whole(x).detach()),
                roles=sorted({v.role for v in tp.layouts(model).values()}))


def tp_deploy_surfaces(mesh, calib_seed: int = 5) -> dict:
    """The serving surfaces of ``_tp_parity``: int8 ResNet-18 (fold, then
    quantize), width-pruned ResNet-18 (trunks and chains at 0.5, round_to 8) and
    the planner's winner from injected timings, each sharded by the ``resnet``
    preset (warn off) against its replicated forward, with the ``qmatmul``
    calls of the int8 forward."""
    import copy as _copy

    from convnet_approximater_tpu_torch import deploy, deploy_planner
    from convnet_approximater_tpu_torch.models import ResNet
    from convnet_approximater_tpu_torch.nn import channels_last, init_weights
    from convnet_approximater_tpu_torch.ops import qmatmul as qmm
    from convnet_approximater_tpu_torch.parallel import tp

    rs = np.random.RandomState(calib_seed)
    calib = [nchw(rs.randn(4, 32, 32, 3).astype(np.float32)) for _ in range(2)]
    x = nchw(rs.randn(4, 32, 32, 3).astype(np.float32))

    def make(seed):
        m = ResNet(18, 16)
        init_weights(m, torch.Generator().manual_seed(seed))
        return channels_last(m).eval()

    surfaces = {}
    q = make(6)
    deploy.fold_batchnorm(q)
    surfaces["int8"] = (q, deploy.quantize_int8(q, calib))
    p = make(7)
    surfaces["pruned"] = (p, (deploy.prune_trunks(p, keep_ratio=0.5, round_to=8),
                              deploy.prune_chains(p, keep_ratio=0.5, round_to=8)))
    fixed = {"trunk+chainprune/0.5+int8": 0.001}
    cands = [c for c in deploy_planner.default_candidates(make(8), torch.float32)
             if c[0].startswith(("dense", "int8", "trunk+chainprune"))]
    plan = deploy_planner.plan_serving(lambda: make(8), (4, 32, 32, 3), dtype=torch.float32,
                                       candidates=cands, min_agree=0.0, calib_batches=calib,
                                       verbose=False, time_fn=lambda name, *a: fixed.get(name, 1.0))
    surfaces["planner"] = (plan["model"], plan["winner"])
    out = {}
    for key, (m, info) in surfaces.items():
        rows = []  # a row-sharded block conv's output, replicated then sharded

        def keep(module, args, y):
            rows.append(y.detach().clone())

        with torch.no_grad():
            whole = _copy.deepcopy(m)
            handle = whole.layer1[0].conv2.register_forward_hook(keep)
            ref = whole(x)
            handle.remove()
            tp.shard_module(m, mesh, 2, "resnet", warn=False)
            handle = m.layer1[0].conv2.register_forward_hook(keep)
            calls = Calls(qmm, "qmatmul")
            try:
                y = m(x)
            finally:
                calls.close()
                handle.remove()
        out[key] = dict(y=y, ref=ref, info=info, qmatmul=calls.shapes, row=rows,
                        roles={k: v.role for k, v in tp.layouts(m).items()})
    return out


def tp_job(families: dict, x: dict, labels: dict, tol: dict, data: int = 1,
           extras: bool = True) -> dict:
    """On a ``(data, world / data)`` mesh: every family of ``families`` (name:
    ``(weights npz, JAX npz)``) by :func:`tp_family`; with ``extras``, the
    dropout masks (:func:`tp_dropout`), rules no preset has
    (:func:`tp_explicit`), the deploy surfaces
    (:func:`tp_deploy_surfaces`), a dim the model axis does not divide, a
    sharded model laid out spatially and back (its tensor-parallel form
    again), and the refusal of tensor parallelism after spatial sharding."""
    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.nn import Linear
    from convnet_approximater_tpu_torch.parallel import tp, tp_layers

    n = dist.get_world_size()
    mesh = parallel.make_mesh(data=data, model=n // data)
    out = {name: tp_family(name, paths[0], x[name], labels[name], paths[1], mesh, tol[name])
           for name, paths in families.items()}
    if not extras:
        return out
    out["dropout"] = tp_dropout(mesh)
    out["explicit"] = tp_explicit(mesh)
    out["deploy"] = tp_deploy_surfaces(mesh)
    head = torch.nn.Module()
    head.head = Linear(4, 5)
    try:
        tp.shard_module(head, mesh, 2, [("head/weight", (None, "model"))])
    except ValueError as e:
        out["uneven"] = str(e)
    head = torch.nn.Module()
    head.head = Linear(4, 6)
    tp.shard_module(head, mesh, 2, [("head/weight", (None, "model"))])
    parallel.spatial_module(head, mesh)  # spatial sharding beside tensor parallelism
    laid_out = (parallel.is_spatial(head), "_tp" in head.head.__dict__)
    parallel.unspatial_module(head)
    out["spatial"] = laid_out + (head.head.__dict__["forward"].__func__ is tp_layers.tp_forward,)
    whole = parallel.spatial_module(randomized("mscan", 0), mesh)
    try:
        tp.shard_module(whole, mesh, 2, "mscan")
    except NotImplementedError as e:
        out["spatial_then_tp"] = str(e)
    return out


def tp_train_job(l2: dict, helper: dict) -> dict:
    """Tensor-parallel training on a ``(world / 2, 2)`` mesh: the
    ``L2Reconstruct`` config ``l2["cfg"]`` (its ``other_args`` name the model
    axis), and each ``TrainHelper`` run of ``helper["runs"]`` (name: config) on
    ResNet-18 from the weights at ``helper["weights"]``, with what the rank
    held while it trained."""
    from convnet_approximater_tpu_torch.classification import train as train_mod
    from convnet_approximater_tpu_torch.parallel import tp

    held = []
    enable = train_mod.TrainHelper._enable_tp

    def keeping(self, *args):
        enable(self, *args)
        held.append(dict(bytes=tp.shard_bytes(self.model), sharded=sorted(self.tp.dims),
                         opt={n: tuple(s["mu"].shape if "mu" in s else s["trace"].shape)
                              for n, s in self.optimizer.state.items()}))

    train_mod.TrainHelper._enable_tp = keeping
    out = dict(l2=l2_run(l2["cfg"], l2["work"])) if l2 else {}
    try:
        for name, cfg in helper["runs"].items():
            out[name] = helper_run(tp_model("resnet", helper["weights"]).train(), cfg)
            out[name]["held"] = held[-1]
    finally:
        train_mod.TrainHelper._enable_tp = enable
    return out


def tp_dp_job(families: dict, x: dict, labels: dict, tol: dict, helper: dict,
              resumed: dict) -> dict:
    """On a (2, world / 2) mesh: :func:`tp_job` of ``families`` (no extras),
    :func:`tp_train_job`'s ``TrainHelper`` runs, and a run resumed from a
    tensor-parallel checkpoint (``resumed``: weights and config)."""
    out = tp_job(families, x, labels, tol, data=2, extras=False)
    out.update(tp_train_job(None, helper))
    out["resumed"] = helper_run(tp_model("resnet", resumed["weights"]).train(), resumed["cfg"])
    return out


# -- spatial sharding -----------------------------------------------------------
def spatial_job(models: dict, x: np.ndarray, data: int, blocks: dict = None,
                maps: np.ndarray = None, extras: bool = False) -> dict:
    """Each model of ``models`` (name: an eval model with its weights) laid out
    by ``spatial_module`` over a ``(data, world / data)`` mesh: its logits on
    this rank's block of ``x`` (two forwards), the data axis's rows gathered;
    the kernel calls and collectives of the second forward; each module of
    ``blocks`` laid out alike, its output on this rank's block of the NCHW
    ``maps`` gathered whole (``block/<name>``); and, with ``extras``, what
    spatial sharding refuses."""
    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops
    from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops
    from convnet_approximater_tpu_torch.parallel import spatial

    n = dist.get_world_size()
    mesh = parallel.make_mesh(data=data, model=n // data)
    xt = nchw(x)
    out = {}
    for name, model in models.items():
        parallel.spatial_module(model, mesh)
        xs = parallel.shard_spatial(xt, mesh)
        with torch.no_grad():
            y = model(xs)
            calls = [Calls(fused_ops, "msca_fused"), Calls(cascade_ops, "parallel_cascade")]
            collectives = [Numels(dist, "all_gather", 1), Numels(dist, "all_reduce", 0)]
            spatial.stats.reset()
            try:
                y2 = model(xs)
            finally:
                for c in calls + collectives:
                    c.close()
        out[name] = dict(y=parallel.gather_spatial(y, mesh), same=torch.equal(y, y2),
                         rows=tuple(xs.shape), msca_fused=len(calls[0].shapes),
                         parallel_cascade=len(calls[1].shapes),
                         windows=calls[0].shapes + calls[1].shapes,
                         all_gather=collectives[0].numels, all_reduce=collectives[1].numels,
                         sent=spatial.stats.sent_bytes)
    for name, block in (blocks or {}).items():
        parallel.spatial_module(block, mesh)
        with torch.no_grad():
            y = block(parallel.shard_spatial(torch.from_numpy(maps).contiguous(
                memory_format=torch.channels_last), mesh))
        out[f"block/{name}"] = parallel.gather_spatial(y, mesh)
    if extras:
        out["refused"] = spatial_refusals(mesh, xt)
    return out


def spatial_refusals(mesh, xt: torch.Tensor) -> dict:
    """What spatial sharding refuses over ``mesh``, each message by case, and
    under ``pools`` ResNet-18's spatially sharded logits beside its whole ones."""
    from convnet_approximater_tpu_torch import deploy, parallel

    out = {}

    def refused(case, fn, error=NotImplementedError):
        try:
            fn()
        except error as e:
            out[case] = str(e)

    model = parallel.spatial_module(randomized("mscan", 0), mesh)
    xs = parallel.shard_spatial(xt, mesh)
    with torch.no_grad():
        refused("training", lambda: model.train()(xs))
    model.eval()
    refused("autograd", lambda: model(xs))
    refused("compile_serving", lambda: deploy.compile_serving(model, xs))
    refused("pipeline after", lambda: model.backbone.enable_pipeline(mesh))
    piped = randomized("mscan", 0)
    piped.backbone.enable_pipeline(mesh)
    refused("pipeline before", lambda: parallel.spatial_module(piped, mesh))
    resnet = randomized("resnet", 0)
    with torch.no_grad():
        whole = resnet(xt)
        parallel.spatial_module(resnet, mesh)
        out["pools"] = (parallel.gather_spatial(resnet(xs), mesh), whole)
    refused("no row form", lambda: parallel.spatial_module(
        torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.AvgPool2d(2)), mesh))
    refused("uneven", lambda: parallel.shard_spatial(xt[:, :, :xt.shape[2] - 1], mesh),
            ValueError)
    return out


SPATIAL_KERNELS = ("lowrank_conv", "qmatmul", "msca_fused", "parallel_cascade")  # op modules


def spatial_families_job(path: str, data: int = 1) -> dict:
    """Each case of the file at ``path`` (name: ``model``, the NHWC input
    ``x`` and ``tp``, a tensor-parallel preset or None) laid out over a
    ``(data, world / data)`` mesh: sharded by ``tp.shard_module`` first where
    ``tp`` names a preset, then by ``spatial_module``.  Its output on this
    rank's block of ``x`` (two forwards), gathered whole; each port kernel's
    calls and window shapes in the second forward, its collectives and the
    bytes it moved; beside tensor parallelism, the bytes of parameters the
    rank holds before and after and the tensor-parallel forward after
    ``unspatial_module`` on the rank's batch rows."""
    import importlib

    from convnet_approximater_tpu_torch import parallel
    from convnet_approximater_tpu_torch.parallel import spatial, tp

    cases = torch.load(path, weights_only=False)
    n = dist.get_world_size()
    mesh = parallel.make_mesh(data=data, model=n // data)
    ops = {name: importlib.import_module(f"convnet_approximater_tpu_torch.ops.{name}")
           for name in SPATIAL_KERNELS}
    out = {}
    for name, case in cases.items():
        model, xt = case["model"], nchw(case["x"])
        res = {}
        if case.get("tp"):
            tp.shard_module(model, mesh, n // data, case["tp"], warn=False)
            res["held"] = tp.shard_bytes(model)
        parallel.spatial_module(model, mesh)
        xs = parallel.shard_spatial(xt, mesh)
        with torch.no_grad():
            y = model(xs)
            calls = {k: Calls(ops[k], k) for k in ops}
            collectives = [Numels(dist, "all_gather", 1), Numels(dist, "all_reduce", 0)]
            spatial.stats.reset()
            try:
                y2 = model(xs)
            finally:
                for c in list(calls.values()) + collectives:
                    c.close()
        res.update(y=parallel.gather_spatial(y, mesh), same=torch.equal(y, y2),
                   rows=tuple(xs.shape), calls={k: c.shapes for k, c in calls.items()},
                   all_gather=collectives[0].numels, all_reduce=collectives[1].numels,
                   sent=spatial.stats.sent_bytes, gathered=spatial.stats.gathered_bytes)
        if case.get("tp"):
            res["held_after"] = tp.shard_bytes(model)
            parallel.unspatial_module(model)
            rows = parallel.shard_rows(len(case["x"]), parallel.batch_sharding(mesh))
            with torch.no_grad():
                res["tp_after"] = model(nchw(case["x"][rows]))
        out[name] = res
    return out
