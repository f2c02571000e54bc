"""GPipe pipelines across processes in the port (``parallel/pp.py``,
``parallel/pp_model.py``, ``models/stage_exec.py``, ``ClassInference``'s
``pipeline_parallel``) against the plain forward and the JAX package.

The ranks are gloo processes on the CPU (``tests/torch_ranks.py``), spawned
twice per module: a (1, 2) mesh and a (1, 4) mesh, each a pipe of 2 or 4
ranks.  Each rank runs ``pipeline_blocks`` on the 4 identical blocks of a tiny
MSCAN's stage 3 at M = n and M = 2n, and its three errors; the whole-model
pipeline of tiny MSCAN, ConvNeXt and ResNet-18 at M = 2n; the in-stage
pipelines of MSCAN and ConvNeXt; ``ValidateHelper(use_mesh=True)`` on a tiny
MSCAN pipelined over a (n // 2, 2) mesh; ``ClassInference``'s wiring, and on
the 2 ranks its pipelined reports in both modes, each validated with
``use_mesh=True``.  The weights are one npz per model, loaded by every
rank and by the JAX package.

Tolerances: the blocks against their sequence 1e-6 relative; the whole-model
pipeline against the plain forward and the JAX forward rtol 2e-4 / atol 2e-5,
and the in-stage pipeline against the plain forward rtol 2e-5 / atol 2e-6
(the JAX tests' own, ``tests/test_pp_model.py:101-102`` and
``tests/test_pipeline_parallel.py:122-123``); against the plain forward on the
same microbatch split, bit for bit (the same ops on the same rows).
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from convnet_approximater_tpu.models import ConvNeXt as JConvNeXt  # noqa: E402
from convnet_approximater_tpu.models import MSCAN_Classifier as JMSCAN  # noqa: E402
from convnet_approximater_tpu.models import ResNet as JResNet  # noqa: E402
from convnet_approximater_tpu.parallel import partition_units as jpartition_units  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch.convert import variables_of  # noqa: E402
from convnet_approximater_tpu_torch.parallel import (partition_units, release, restore,  # noqa: E402
                                                     subtree)
from convnet_approximater_tpu_torch.runner import Runner  # noqa: E402
from convnet_approximater_tpu_torch.utils import init_cfg, save_model, update_cfg  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
BLOCKS_RTOL = 1e-6
WHOLE = dict(rtol=2e-4, atol=2e-5)
STAGE = dict(rtol=2e-5, atol=2e-6)
EVAL_CFG = dict(input_size=(32, 32, 3), num_classes=16, num_batches=2, log_freq=1)
JAX_MODELS = {"mscan": lambda: JMSCAN(**torch_ranks.TINY_MSCAN),
              "convnext": lambda: JConvNeXt(**torch_ranks.TINY_CONVNEXT),
              "resnet": lambda: JResNet(18, 10)}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    npz = {}
    for seed, name in enumerate(JAX_MODELS):
        npz[name] = str(d / f"{name}.npz")
        save_model(variables_of(torch_ranks.randomized(name, seed)), npz[name])
    # a tiny MSCAN config and its Runner checkpoint for ClassInference
    cfg = d / "tiny_mscan.py"
    cfg.write_text(
        f"_base_ = [{os.path.join(REPO, 'configs/msca-rep/dummy_mscan-t.py')!r}]\n"
        f"model = dict(num_channels={torch_ranks.TINY_MSCAN['num_channels']}, "
        f"num_blocks={torch_ranks.TINY_MSCAN['num_blocks']}, "
        f"exp_ratios={torch_ranks.TINY_MSCAN['exp_ratios']}, num_classes=16)\n"
        f"hooks = []\n")
    init_cfg(str(cfg))
    update_cfg(work_dir=str(d / "run"), config_name="tiny_mscan", seed=0)
    runner = Runner(device="cpu")
    runner.run()
    rs = np.random.RandomState(7)
    return dict(npz=npz, x=rs.randn(8, 32, 32, 3).astype(np.float32),
                blocks_x=rs.randn(8, 4, 4, 24).astype(np.float32),
                eval_cfg=dict(EVAL_CFG, batch_size=8),
                ci=dict(cfg=str(cfg), ckpt=runner.output_path, work_dir=str(d / "ci"),
                        eval_cfg=dict(EVAL_CFG, batch_size=4, use_mesh=True)))


@pytest.fixture(scope="module", params=WORLDS, ids=[f"{n} ranks" for n in WORLDS])
def ranks(request, inputs, tmp_path_factory):
    n = request.param
    return n, torch_ranks.spawn(torch_ranks.pipeline_job, n, tmp_path_factory.mktemp(f"w{n}"),
                                npz=inputs["npz"], x=inputs["x"], blocks_x=inputs["blocks_x"],
                                ci=inputs["ci"] if n == 2 else None, eval_cfg=inputs["eval_cfg"])


@pytest.fixture(scope="module")
def jax_logits(inputs):
    """The JAX package's eval forward of each npz."""
    out = {}
    for name, make in JAX_MODELS.items():
        variables = jser.unflatten_tree(dict(np.load(inputs["npz"][name])))
        model = make()
        forward = jax.jit(lambda p, s, x: model.apply(p, x, state=s, training=False)[0])
        out[name] = np.asarray(forward(variables["params"], variables.get("state", {}),
                                       jnp.asarray(inputs["x"])))
    return out


def test_pipeline_blocks_is_the_blocks_in_sequence(ranks):
    n, results = ranks
    for res in results:
        assert sorted(res["blocks"]) == [n, 2 * n]  # M = n and M > n
        for y, seq in res["blocks"].values():
            assert y.shape == seq.shape and rel(y, seq) < BLOCKS_RTOL
        # every pipe rank returns the whole batch
        assert torch.equal(res["blocks"][n][0], results[0]["blocks"][n][0])


def test_pipeline_blocks_keeps_the_jax_errors(ranks):
    n, results = ranks
    errors = results[0]["errors"]
    assert errors["ragged"] == "pipeline_blocks: ragged block stack"
    assert errors["split"] == f"pipeline_blocks: 5 blocks don't split over {n} stages"
    assert errors["microbatches"] == f"pipeline_blocks: batch {n + 1} % microbatches {n} != 0"


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_pipeline_units_compose_to_the_forward(inputs, name):
    """The units in order are the eval forward, bit for bit (JAX
    ``test_pp_model.py::test_pipeline_units_compose_to_forward``)."""
    model = torch_ranks.load(name, inputs["npz"][name])
    x = torch_ranks.nchw(inputs["x"])
    with torch.no_grad():
        h = x
        for unit in model.pipeline_units():
            h = unit.module(h)
        assert torch.equal(h, model(x))
    assert subtree(model, "no", "such") is None
    assert subtree(model, *model.pipeline_units()[1].name.split(".")) is \
        model.pipeline_units()[1].module


def test_partition_units_is_the_jax_partition():
    rs = np.random.RandomState(0)
    cases = [[9, 1, 1, 1, 8, 1]] + [list(rs.randint(0, 50, size=u)) for u in (5, 12, 19)] \
        + [list(rs.uniform(0, 1e9, size=25))]
    for costs in cases:
        for n in range(1, min(len(costs), 6) + 1):
            assert partition_units(costs, n) == jpartition_units(costs, n)
    with pytest.raises(ValueError, match="cannot split 1 units into 2 stages"):
        partition_units([1.0], 2)


@pytest.mark.parametrize("name", sorted(JAX_MODELS))
def test_whole_model_pipeline_matches_plain_and_jax(ranks, jax_logits, name):
    n, results = ranks
    want = jax_logits[name]
    for res in results:
        got = res["whole"][name]
        y = got["y"].numpy()
        assert torch.equal(got["y"], got["split"])
        np.testing.assert_allclose(y, got["plain"].numpy(), **WHOLE)
        np.testing.assert_allclose(y, want, **WHOLE)
        assert torch.equal(got["after"], got["plain"])  # close() gave the weights back
        report = got["report"]
        assert len(report) == n and abs(sum(r["share"] for r in report) - 1) < 1e-9
        assert all(r["units"] for r in report)
        assert got["owned"] < got["total"]  # the other stages' units were released


@pytest.mark.parametrize("name", ["mscan", "convnext"])
def test_in_stage_pipeline_matches_the_plain_forward(ranks, name):
    n, results = ranks
    for res in results:
        got = res["stage"][name]
        # every stage of 2 and 4 identical blocks splits over 2 ranks; over 4 only stage 3
        assert got["stages"] == ([0, 1, 2, 3] if n == 2 else [2])
        assert torch.equal(got["y"], got["split"])
        np.testing.assert_allclose(got["y"].numpy(), got["plain"].numpy(), **STAGE)
        assert torch.equal(got["after"], got["plain"])


def test_release_drops_the_kernel_layers_caches(inputs):
    """A block released to another pipe rank keeps none of MSCA's and its
    strip banks' packed weights (each kernel layer's ``drop_caches``), and the
    restored blocks build them again and give the forward they gave before."""
    from convnet_approximater_tpu_torch.models.stage_exec import resolve_pipeline_carrier

    model = torch_ranks.load("mscan", inputs["npz"]["mscan"])
    x = torch_ranks.nchw(inputs["x"])
    with torch.no_grad():
        before = model(x)
        caching = [m for m in model.modules() if hasattr(m, "drop_caches")]
        held = lambda: [m for m in caching  # noqa: E731
                        if any(m.__dict__.get(k) is not None
                               for k in ("_pack", "_packed", "_maps", "_kernel_args"))]
        built = held()
        assert built
        saved = [(s, release(s)) for s in resolve_pipeline_carrier(model).pipeline_stages()]
        assert held() == []
        for s, kept in saved:
            restore(s, kept)
        assert torch.equal(model(x), before) and held() == built


def test_each_pipe_rank_holds_its_share_of_a_pipelined_stage(ranks):
    n, results = ranks
    for res in results:
        for got in res["stage"].values():
            for s, (owned, total) in enumerate(zip(got["owned"], got["total"])):
                assert owned == (total // n if s in got["stages"] else total)
            assert got["restored"] == got["total"]


def test_data_parallel_validation_of_a_pipelined_model(ranks, inputs):
    """``ValidateHelper(use_mesh=True)`` on a model stage-pipelined over a
    (n // 2, 2) mesh: the pipe ranks of a data group load the same rows, so
    every rank returns the numbers of one process's plain validation (the
    counts exactly, the loss to the in-stage pipeline's tolerance)."""
    from convnet_approximater_tpu_torch.classification.validate import ValidateHelper

    _, results = ranks
    want = ValidateHelper(torch_ranks.load("mscan", inputs["npz"]["mscan"]), inputs["eval_cfg"],
                          device="cpu").validate()
    for res in results:
        got = res["validate"]
        np.testing.assert_allclose(got["loss"], want["loss"], **STAGE)
        assert (got["top1"], got["top5"]) == (want["top1"], want["top5"])


def test_class_inference_pipelines_across_the_ranks(ranks):
    n, results = ranks
    main = results[0]
    # MSCAN's backbone and ConvNeXt carry the engine; ResNet-18 warns and serves plainly
    assert main["wired"] == [True, True, False]
    assert any("ResNet has no pipeline-capable backbone" in m for m in main["log"])
    assert main["errors"]["pipeline_parallel"] == \
        f"pipeline_parallel={n + 1} doesn't divide {n} processes"
    if n != 2:
        return
    stage, whole = main["reports"]["stage"], main["reports"]["whole"]
    assert list(stage) == list(whole) == ["original", "approximated"]
    for tag in stage:
        assert stage[tag]["macs"] == whole[tag]["macs"] > 0 and stage[tag]["ms"] > 0
        # use_mesh=True: the stage report validates through the pipeline, the whole
        # report after it (the plain model, each rank its rows): the same numbers
        np.testing.assert_allclose(stage[tag]["eval"]["loss"], whole[tag]["eval"]["loss"],
                                   **STAGE)
        assert stage[tag]["eval"]["top1"] == whole[tag]["eval"]["top1"]
        assert stage[tag]["eval"]["top5"] == whole[tag]["eval"]["top5"]
    assert sum(f"{n}-stage whole pipeline fwd median" in m for m in main["log"]) == 2
    assert sum(f"[original] pp stage {k}:" in m for m in main["log"] for k in range(n)) == n
