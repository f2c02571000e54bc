"""Ranks of a gloo process group on the CPU, for the port's tests across
processes (``tests/test_torch_parallel_*.py``, ``tests/test_torch_serve_cli.py``).

:func:`spawn` starts ``world`` processes, each joins the group through a
file store under the test's temporary directory, runs one job of this module
with one thread, and saves what it returns; the parent gets every rank's
result.  This module imports no JAX, so the ranks start quickly: the tests
hold the ranks' results against the JAX package in the parent process.
"""

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
    from convnet_approximater_tpu_torch.nn import channels_last, init_weights

    model = build(name)
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
