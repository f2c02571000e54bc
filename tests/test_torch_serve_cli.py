"""The port's serving CLIs and its forward timer on the CPU (this file imports
no JAX, so that its card tests run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_serve_cli.py``).

* ``export_model`` -> ``serve`` of ``configs/low-rank-exp/dummy_alexnet.py``
  at b=2, 64², in process, int8 (8 ``qmatmul`` per forward): the artifact
  loads and serves, plain and with ``--ship-uint8``; exported with a symbolic
  batch it serves a batch of 1 padded to 2 and a batch of 5 in chunks of 2.
  The float32 tests pass ``--dtype float32``: the CLIs serve bfloat16 by default.
* The refusals: ``--params`` (the artifact carries its weights), a foreign
  ``--platforms``; and what serves now: ``--dtype bfloat16`` (``export_model``
  writes an artifact of bf16 avals that gives the live bf16 model's bits,
  ``serve_mscan`` serves a bf16 surface) and ``--data-parallel`` (two gloo
  ranks, ``tests/torch_ranks.py``: ``--min-batch 1`` rises to the world size,
  a batch of 3 is padded to 4 and served as the one process serves it).
* ``serve_mscan --tiny`` on the CPU; ``plan_serving --export`` on a tiny
  MSCAN config under an injected timer: the winner's artifact gives the
  plan's logits, and its sidecars hold its weights and normalization.
* The forward timer: on the CPU the eager median, as before; on a card a
  CUDA graph replayed back to back (marked ``cuda``, skipped without one).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks  # noqa: E402

from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch import (export_model, plan_serving, serve,  # noqa: E402
                                            serve_mscan)
from convnet_approximater_tpu_torch.hooks import inference_time_hook as timer  # noqa: E402
from convnet_approximater_tpu_torch.layers import CascadeConv  # noqa: E402
from convnet_approximater_tpu_torch.nn import Conv2d, ReLU, channels_last  # noqa: E402
from convnet_approximater_tpu_torch.runner.runner import read_checkpoint  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMMY_ALEX = os.path.join(REPO, "configs", "low-rank-exp", "dummy_alexnet.py")
LOADED_RTOL = 1e-6


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def export(out, *extra):
    return export_model.main(["--config", DUMMY_ALEX, "--out", str(out), "--batch", "2",
                              "--input-size", "64", "64", "3", "--quantize", "int8",
                              "--device", "cpu", "--dtype", "float32", *extra])


def bf16_artifact(res):
    """An ``export_model --dtype bfloat16`` result: bf16 avals and meta, the
    int8 modules' float32 scales, the live bf16 model's bits."""
    assert res["ops"] == {"qmatmul": 8} and res["err"] < export_model.ARTIFACT_TOL
    art = res["artifact"]
    assert art.in_avals[-1].dtype == art.out_avals[0].dtype == torch.bfloat16
    with open(res["out"] + ".meta.json") as f:
        assert json.load(f)["dtype"] == "bfloat16"
    scales = [p for n, p in res["model"].named_parameters() if n.endswith(("w_scale", "act_scale"))]
    assert scales and all(p.dtype == torch.float32 for p in scales)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert torch.equal(art(x), res["model"](x))


def data_parallel_serve(tmp_path):
    """``serve --data-parallel`` over two gloo ranks with ``--min-batch 1``,
    against one process serving the same artifact."""
    out = str(export(tmp_path / "x.pt2", "--symbolic-batch")["out"])
    argv = ["--artifact", out, "--batch", "3", "--batches", "1", "--min-batch", "1",
            "--device", "cpu"]
    return (torch_ranks.spawn(torch_ranks.serve_job, 2, tmp_path / "ranks",
                              argv=argv + ["--data-parallel"]),
            serve.main(argv))


def pads_up_to_the_world_size(result):
    ranks, alone = result
    for res in ranks:
        assert res["world"] == 2 and res["min_batch"] == 2 and res["served"] == 3
        assert res["logits"].shape == (3, 10)
        assert rel(res["logits"], alone["logits"]) < LOADED_RTOL


def bf16_serve_mscan(res):
    """``serve_mscan --tiny --dtype bfloat16``: a bf16 surface served."""
    from convnet_approximater_tpu_torch.utils.dtype import serving_dtype

    assert serving_dtype(res["model"]) == torch.bfloat16 and res["served"] == 4 * 8
    assert res["preds"].shape == (8,)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("artifacts")
    return {"static": export(d / "alex.pt2"),
            "symbolic": export(d / "alex_sym.pt2", "--symbolic-batch")}


def test_export_model_writes_the_artifact_its_params_and_meta(artifacts):
    res = artifacts["static"]
    out = res["out"]
    assert res["err"] < export_model.ARTIFACT_TOL and res["ops"] == {"qmatmul": 8}
    with open(out + ".meta.json") as f:
        meta = json.load(f)
    assert meta["quantize"] == "int8" and meta["dtype"] == "float32"
    assert meta["mean"] == [0.485, 0.456, 0.406] and meta["input_shape"] == [2, 3, 64, 64]
    params = np.load(out + ".params.npz")
    assert any(k.startswith("params/") and k.endswith("weight_q") for k in params.files)
    loaded = deploy.load_serving(out)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        assert torch.equal(loaded(x), res["model"](x))  # int8: bit-equal


@pytest.mark.parametrize("case", ["plain", "ship-uint8", "pad 1 to 2", "chunks of 2"])
def test_serve_drives_the_artifact(artifacts, case, capsys):
    args = {"plain": ("static", ["--batch", "2"]),
            "ship-uint8": ("static", ["--batch", "2", "--ship-uint8"]),
            "pad 1 to 2": ("symbolic", ["--batch", "1", "--min-batch", "2"]),
            "chunks of 2": ("symbolic", ["--batch", "5", "--max-batch", "2", "--min-batch", "1"])}
    which, extra = args[case]
    res = serve.main(["--artifact", artifacts[which]["out"], "--batches", "3",
                      "--device", "cpu", *extra])
    out = capsys.readouterr().out
    b = int(extra[1])
    assert res["served"] == 3 * b and np.isfinite(res["checksum"])
    assert "img/s end-to-end" in out and "overriding --image-size 224" in out
    # one session per distinct batch size the forward saw (chunks 2, 2, 1)
    assert res["sessions"] == (2 if case == "chunks of 2" else 1)


def test_serve_overrides_a_batch_the_artifact_does_not_take(artifacts, capsys):
    res = serve.main(["--artifact", artifacts["static"]["out"], "--batch", "4", "--batches", "1",
                      "--device", "cpu"])
    assert res["batch"] == 2 and "batch-static at 2" in capsys.readouterr().out


# an entry whose error is None runs, and its third item checks what it returns
REFUSALS = {
    "export_model --dtype bfloat16": (lambda p: export(p / "x.pt2", "--dtype", "bfloat16"),
                                      None, bf16_artifact),
    "export_model --platforms cpu,tpu": (lambda p: export(p / "x.pt2", "--platforms", "cpu,tpu"),
                                         ValueError, "export once per device"),
    "serve --params": (lambda p: serve.main(["--artifact", "a.pt2", "--params", "a.npz"]),
                       NotImplementedError, "carries its weights"),
    "serve --data-parallel": (data_parallel_serve, None, pads_up_to_the_world_size),
    "serve_mscan --dtype bfloat16": (lambda p: serve_mscan.main(["--tiny", "--dtype", "bfloat16",
                                                                 "--device", "cpu"]),
                                     None, bf16_serve_mscan),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals(tmp_path, name):
    run, error, match = REFUSALS[name]
    if error is None:  # bf16 and data-parallel serving run now
        match(run(tmp_path))
        return
    with pytest.raises(error, match=match):
        run(tmp_path)


def test_serve_mscan_tiny_on_the_cpu(capsys):
    res = serve_mscan.main(["--tiny", "--device", "cpu", "--dtype", "float32"])
    assert res["sites"]["mscarep"] == 4 and res["sites"]["fold"] == 5
    assert res["served"] == 4 * 8 and res["preds"].shape == (8,)
    assert "img/s end-to-end" in capsys.readouterr().out


def test_plan_serving_exports_the_winner(tmp_path, monkeypatch):
    """A timer that favours the MscaRep dconv0 surface (a cascade conv0):
    the plan's winner is exported, the artifact gives its logits, and its
    sidecars hold the served weights and the recorded normalization."""
    monkeypatch.setattr(timer, "forward_seconds", lambda model, *a, **k: 0.5 if any(
        isinstance(getattr(m, "conv0", None), CascadeConv) for m in model.modules()) else 1.0)
    cfg = tmp_path / "tiny_mscan.py"
    cfg.write_text("model = dict(type='MSCAN_Classifier', num_channels=(8, 16), "
                   "num_blocks=(1, 1), exp_ratios=(2, 2), num_classes=10)\n")
    art = tmp_path / "winner.pt2"
    plan = plan_serving.main(["--config", str(cfg), "--batch", "2", "--input-size", "32", "32",
                              "3", "--only", "mscarep/d1", "--out", str(tmp_path / "plan.json"),
                              "--export", str(art), "--norm-mean", "0.5", "0.5", "0.5",
                              "--norm-std", "0.25", "0.25", "0.25", "--device", "cpu",
                              "--dtype", "float32"])
    assert plan["winner"].startswith("mscarep/") and plan["export"] == str(art)
    with open(str(art) + ".meta.json") as f:
        meta = json.load(f)
    assert meta["surface"] == plan["winner"] and meta["dtype"] == "float32"
    assert meta["mean"] == [0.5] * 3 and meta["std"] == [0.25] * 3
    assert meta["speedup_vs_dense"] == plan["speedup_vs_dense"] == 2.0
    assert meta["input_shape"] == [2, 3, 32, 32]
    assert serve.read_meta(str(art)) == ([0.5] * 3, [0.25] * 3)
    saved, state = read_checkpoint(str(art) + ".params.npz"), plan["model"].state_dict()
    assert sorted(saved) == sorted(state)
    assert all(torch.equal(saved[k].to(state[k].dtype), state[k]) for k in state)
    loaded = deploy.load_serving(str(art))
    assert deploy.custom_op_counts(loaded) == {"parallel_cascade": 4}
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        assert rel(loaded(x), plan["model"](x)) <= LOADED_RTOL


def small_net():
    return channels_last(torch.nn.Sequential(Conv2d(3, 4, 3, padding=1), ReLU(),
                                             Conv2d(4, 2, 1))).eval()


def test_timer_on_the_cpu_is_the_eager_median():
    model = small_net()
    times = timer.time_forward(model, (2, 8, 8, 3), "cpu", num_iters=4, warmup=1)
    assert times.shape == (4,) and (times > 0).all()
    t = timer.forward_times(model, (2, 8, 8, 3), num_iters=5, warmup=2)
    assert t["ms"] == t["eager_median_ms"] == float(np.median(t["times"]))
    assert t["forwards"] == 7 and t["times"].shape == (5,)
    assert timer.forward_seconds(model, (2, 8, 8, 3), 3, 1) > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_timer_on_the_card_is_a_graph_replayed_back_to_back(card):
    model = small_net().to(card)
    calls = []
    capture = deploy.compile_serving

    def counted(*args):
        calls.append(1)
        return capture(*args)

    deploy.compile_serving = counted
    try:
        t = timer.forward_times(model, (8, 32, 32, 3), num_iters=10, warmup=2)
        assert timer.time_forward(model, (8, 32, 32, 3), card, 10, 2).shape == (1,)
    finally:
        deploy.compile_serving = capture
    assert len(calls) == 2  # a graph per timing call
    assert t["ms"] > 0 and t["eager_median_ms"] > 0 and t["times"].shape == (10,)
    assert t["forwards"] == 12 + timer.CAPTURE_FORWARDS


class Syncs(torch.nn.Module):
    def forward(self, x):
        return x * float(x.sum())  # reads the card back: no graph can hold it


@pytest.mark.cuda
def test_a_forward_that_cannot_be_captured_names_its_module(card):
    model = torch.nn.Sequential(Conv2d(3, 4, 3, padding=1), Syncs()).to(card).eval()
    with pytest.raises(RuntimeError, match="module '1' \\(Syncs\\)"):
        timer.graph_ms(model, (2, 8, 8, 3), num_iters=2, warmup=1)
