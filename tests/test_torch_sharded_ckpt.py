"""The port's sharded checkpoint (``utils/sharded_ckpt.py``, on
``torch.distributed.checkpoint``) against the JAX package's (orbax).

* A tree of arrays, numpy scalars and Python scalars round-trips bit for bit,
  waited for or asynchronous, to host numpy or into an ``abstract_like``
  target; an asynchronous save commits, and the next save waits for it.
* A JAX ``.oshard`` directory is refused with the way across.
* ``CheckpointSaver(backend="sharded")`` over one metric sequence keeps the
  JAX saver's best-k epochs and its ``last``/``model_best`` targets.
* A tiny ``L2Reconstruct`` and a tiny ``TrainHelper`` preempted after epoch 1
  and resumed from the sharded ``last`` end on the uninterrupted run's losses
  and weights, bit for bit.
* The tree restored from the port's checkpoint of a model equals the JAX
  ``restore_sharded`` tree of the same weights, under ``convert``'s names.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("orbax.checkpoint")
torch = pytest.importorskip("torch")

from convnet_approximater_tpu.hooks import finetune as jft  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu.utils import sharded_ckpt as jsc  # noqa: E402
from convnet_approximater_tpu_torch.classification import TrainHelper  # noqa: E402
from convnet_approximater_tpu_torch.convert import variables_of  # noqa: E402
from convnet_approximater_tpu_torch.hooks import finetune as ft  # noqa: E402
from convnet_approximater_tpu_torch.utils import serialize as tser  # noqa: E402
from convnet_approximater_tpu_torch.utils import sharded_ckpt as sc  # noqa: E402
from convnet_approximater_tpu_torch.utils.preempt import PreemptionGuard  # noqa: E402
from tests.test_torch_finetune import FT, TINY_MODEL, TriggerAt, run_port  # noqa: E402
from tests.test_torch_train_helper import BASE, CASES, jax_tinynet, port_model  # noqa: E402

torch.set_num_threads(1)


def sample_tree() -> dict:
    rs = np.random.RandomState(0)
    return {
        "params": {"conv": {"weight": rs.randn(3, 3, 2, 4).astype(np.float32),
                            "bias": rs.randn(4).astype(np.float32)},
                   "a.b": {"idx": rs.randint(0, 9, (5,)).astype(np.int64)}},
        "state": {"bn": {"var": rs.rand(4).astype(np.float64)}},
        "opt": {"count": np.int64(3), "mask": np.array([True, False, True])},
        "meta": {"epoch": 2, "metric": 0.1 + 0.2},
    }


def assert_same_tree(got: dict, want: dict):
    got, want = tser.flatten_tree(got), tser.flatten_tree(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (int, float)):
            assert type(g) is type(w) and g == w, k
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("wait", [True, False])
def test_tree_round_trips_bit_for_bit(tmp_path, wait):
    tree = sample_tree()
    path = sc.save_sharded(str(tmp_path / "t.ckpt.dcp"), tree, wait=wait)
    assert_same_tree(sc.restore_sharded(path), tree)  # waits for an asynchronous save
    assert_same_tree(tser.load_ckpt(path), tree)
    target = sc.abstract_like(tree)
    assert isinstance(target["params"]["conv"]["weight"], torch.Tensor)
    back = sc.restore_sharded(path, target)
    assert back["params"]["conv"]["weight"] is target["params"]["conv"]["weight"]  # in place
    assert_same_tree({k: v.numpy() if isinstance(v, torch.Tensor) else v
                      for k, v in tser.flatten_tree(back).items()}, tser.flatten_tree(tree))


def test_async_save_commits_and_the_next_save_waits_for_it(tmp_path):
    want = tser.flatten_tree(sample_tree())
    first = sc.save_sharded(str(tmp_path / "a.ckpt.dcp"), sample_tree(), wait=False)
    on_card = {"w": torch.arange(5.0)}  # a tensor leaf is brought to the host first
    second = sc.save_sharded(str(tmp_path / "b.ckpt.dcp"), on_card, wait=False)  # waits for a
    assert os.path.isfile(os.path.join(first, ".metadata"))
    sc.wait_for_saves()
    assert os.path.isfile(os.path.join(second, ".metadata"))
    assert_same_tree(tser.load_flat(first), want)
    assert np.array_equal(tser.load_flat(second)["w"], np.arange(5.0, dtype=np.float32))


def test_jax_oshard_directory_is_refused(tmp_path):
    with pytest.raises(ValueError, match="load_ckpt, then save_model to a .ckpt.npz"):
        tser.load_flat(str(tmp_path / "checkpoint-0.ckpt.oshard"))
    with pytest.raises(ValueError, match="ends in .dcp"):
        sc.save_sharded(str(tmp_path / "x.ckpt"), sample_tree())


@pytest.mark.parametrize("decreasing", [False, True])
def test_saver_keeps_the_jax_savers_best_k_and_links(tmp_path, decreasing):
    metrics = [0.3, 0.5, 0.2, 0.6, 0.4]
    variables = {"params": {"w": np.arange(6, dtype=np.float32)}}
    savers = {"jax": jft.CheckpointSaver(str(tmp_path / "jax"), decreasing, 2, "sharded"),
              "port": ft.CheckpointSaver(str(tmp_path / "port"), decreasing, 2, "sharded")}

    def state(name):
        d = savers[name].out_dir
        kept = sorted(f.split(".")[0] for f in os.listdir(d)
                      if f.startswith("checkpoint-") and not os.path.islink(os.path.join(d, f)))
        links = {n: os.path.basename(os.readlink(os.path.join(d, f"{n}.ckpt.{suffix}")))
                 .split(".")[0] for n in ("last", "model_best")
                 for suffix in [("oshard" if name == "jax" else "dcp")]
                 if os.path.islink(os.path.join(d, f"{n}.ckpt.{suffix}"))}
        return kept, links

    for epoch, metric in enumerate(metrics):
        best = {name: s.save_checkpoint(variables, epoch, metric) for name, s in savers.items()}
        assert best["port"] == best["jax"]
        jsc.wait_for_saves()
        sc.wait_for_saves()
        assert state("port") == state("jax"), epoch
    paths = {name: s.save_last(variables, len(metrics) - 1) for name, s in savers.items()}
    assert state("port") == state("jax")
    assert state("port")[1]["last"] == "checkpoint-preempt"
    meta = tser.load_ckpt(str(tmp_path / "port" / "last.ckpt.dcp"))["meta"]
    assert meta["epoch"] == len(metrics) - 1 and np.isnan(meta["metric"])
    assert os.path.basename(paths["port"]) == "checkpoint-preempt.ckpt.dcp"


def test_l2reconstruct_resumes_from_the_sharded_last(tmp_path, monkeypatch):
    """TinyNet scheme-1, AdamW, 3 epochs of 2 steps on the sharded backend: a
    notice before the first step of epoch 2 saves the state after epoch 1, and
    the run resumed from ``last.ckpt.dcp`` takes the uninterrupted run's last
    two steps and ends on its weights, bit for bit."""
    kw = dict(body="asym=True, l2_weight=1.0, cls_weight=0.1,",
              optim='opt="adamw", lr=1e-2, weight_decay=0.05', epochs=3, steps=2, px=16)

    def text(extra=""):
        return TINY_MODEL + FT.format(snap="", extra=', ckpt_backend="sharded"' + extra, **kw)

    full, full_steps = run_port(tmp_path, text(), "full")
    monkeypatch.setattr(TriggerAt, "at", 5)
    monkeypatch.setattr(ft, "PreemptionGuard", TriggerAt)
    killed, _ = run_port(tmp_path, text(), "killed")
    assert next(h for h in killed.hooks if h.name == "L2Reconstruct").result["preempted"]
    last = str(tmp_path / "killed" / "last.ckpt.dcp")
    assert os.readlink(last) == "checkpoint-preempt.ckpt.dcp"
    assert tser.load_ckpt(last)["meta"]["epoch"] == 1
    monkeypatch.setattr(ft, "PreemptionGuard", PreemptionGuard)
    resumed, steps = run_port(tmp_path, text(f", resume={last!r}"), "resumed")
    assert steps == full_steps[4:]
    want, got = full.model.state_dict(), resumed.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    full_dir = tmp_path / "full"
    assert sorted(f for f in os.listdir(full_dir) if f.endswith(".dcp")) == [
        "checkpoint-0.ckpt.dcp", "checkpoint-1.ckpt.dcp", "checkpoint-2.ckpt.dcp",
        "last.ckpt.dcp", "model_best.ckpt.dcp"]


def test_train_helper_resumes_from_the_sharded_last(tmp_path):
    """TinyNet from scratch, AdamW with EMA and grad_accum 2, 2 epochs of 3
    steps on the sharded backend: a notice after epoch 0 saves the full state
    (weights, EMA, optimizer mid-accumulation), and the run resumed from
    ``last.ckpt.dcp`` takes the uninterrupted run's steps 4-6 and ends on its
    weights and EMA, bit for bit."""
    _, init = jax_tinynet()
    flat = {k: np.asarray(v) for k, v in jser.flatten_tree(init).items()}
    cfg = dict(BASE, **CASES["resume"], ckpt_backend="sharded")

    def run(name, stop_after=None, **over):
        helper = TrainHelper(port_model(flat), dict(cfg, work_dir=str(tmp_path / name), **over),
                             device="cpu")
        losses, step = [], helper.train_step

        def recording(*a):
            out = step(*a)
            losses.append(float(out))
            if len(losses) == stop_after:
                helper._guard.trigger()
            return out

        helper.train_step = recording
        helper.train()
        return helper, losses

    full, full_losses = run("full")
    _, cut = run("killed", stop_after=3)
    assert len(cut) == 3
    last = str(tmp_path / "killed" / "last.ckpt.dcp")
    assert os.readlink(last) == "checkpoint-preempt.ckpt.dcp"
    resumed, losses = run("resumed", resume=last)
    assert losses == full_losses[3:]
    for a, b in ((resumed.model, full.model), (resumed.ema, full.ema)):
        want, got = b.state_dict(), a.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_restored_tree_equals_the_jax_restore_of_the_same_weights(tmp_path):
    _, init = jax_tinynet()
    jtree = {**init, "meta": {"epoch": 4, "metric": 0.5}}
    jpath = jsc.save_sharded(str(tmp_path / "w.ckpt.oshard"), jtree, wait=True)
    flat = {k: np.asarray(v) for k, v in jser.flatten_tree(init).items()}
    ttree = {**variables_of(port_model(flat)), "meta": {"epoch": 4, "metric": 0.5}}
    tpath = sc.save_sharded(str(tmp_path / "w.ckpt.dcp"), ttree)
    want = tser.flatten_tree(jsc.restore_sharded(jpath))
    got = tser.flatten_tree(sc.restore_sharded(tpath))
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.asarray(got[k]).tobytes() == np.asarray(w).tobytes(), k
        assert np.asarray(got[k]).shape == np.asarray(w).shape, k
