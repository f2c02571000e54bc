"""The port's serving planner (``deploy_planner``) against the JAX package's.

* ``default_candidates``: the same names on small ConvNeXt, MSCAN and SegNeXt
  models and on AlexNet, ResNet-18 and VGG-16 (float32 in both packages; the
  JAX default is bf16, the port plans float32 only).
* ``plan_serving`` under the fake timers of ``tests/test_deploy_planner.py``
  (a time per candidate name): JAX's winner, report names, times and
  ``qualified`` flags, and the dense floor when nothing reaches
  ``min_agree``.
* ``speedup_vs_dense`` is against the dense candidate (JAX's, in float32,
  against the unfolded reference row of the same name).
* ``recovery_plan`` equals JAX's for every candidate name.
* ``plan_to_json`` and ``reuse_plan``: a replay times nothing, a stale winner
  and a winner that finds no target now (where the reference raises) plan
  again from scratch.
* The CLI: ``--emit-recovery`` writes JAX's chain of configs, each of which
  the port's Runner builds; ``--export`` and bf16 are refused.
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu import deploy_planner as jplanner  # noqa: E402
from convnet_approximater_tpu.models import build_model as jbuild  # noqa: E402
from convnet_approximater_tpu.segmentation import SegNeXt as JSegNeXt  # noqa: E402
from convnet_approximater_tpu.utils.serialize import unflatten_tree  # noqa: E402
from convnet_approximater_tpu_torch import deploy_planner as planner  # noqa: E402
from convnet_approximater_tpu_torch import plan_serving as cli  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.models import build_model  # noqa: E402
from convnet_approximater_tpu_torch.nn import channels_last, init_weights  # noqa: E402
from convnet_approximater_tpu_torch.runner import Runner  # noqa: E402
from convnet_approximater_tpu_torch.segmentation import SegNeXt  # noqa: E402
from convnet_approximater_tpu_torch.utils import init_cfg, update_cfg  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_RTOL = 1e-4
SHAPE = (4, 32, 32, 3)
CONVNEXT = dict(type="ConvNeXt", num_classes=10, depths=(1, 1, 1, 1), dims=(8, 12, 16, 20),
                layer_scale=1.0)
MSCAN = dict(type="MSCAN_Classifier", num_channels=(8, 16), num_blocks=(2, 2), exp_ratios=(4, 4),
             num_classes=7)
SEGNEXT = dict(num_channels=(8, 8, 16, 16), num_blocks=(1, 1, 1, 1), exp_ratios=(2, 2, 2, 2),
               num_classes=5, ham_channels=8, ham_rank=4, ham_iters=2)
NMF_KEY = "state/decode_head/hamburger/nmf_init"
FAKE = {"dense/float32": 0.010, "int8": 0.004, "v3/e=0.9": 0.006, "dwsep/r=1": 0.007,
        "dwsep/r=1+int8": 0.005}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def jax_draw(channels, rank):
    """The JAX head's NMF dictionary start (``segmentation/ham_head.py:63``)."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(42), (1, channels, rank),
                                         jnp.float32, 1e-3, 1.0))


def randomized(model, seed: int = 0):
    """``model`` with weights from ``seed``, BN statistics of order 1 and, for
    SegNeXt, JAX's NMF start; in ``channels_last`` and eval mode."""
    init_weights(model, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy((0.1 * rs.randn(*t.shape)).astype(np.float32)))
        if isinstance(model, SegNeXt):
            ham = model.decode_head.hamburger
            draw = np.array(jax_draw(ham.ham_in.in_channels, ham.rank))
            ham.nmf_init.copy_(torch.from_numpy(draw))
    return channels_last(model).eval()


def factories(cfg, seed: int = 0):
    """``make`` of each package: a fresh model holding the same weights."""
    def make():
        if isinstance(cfg, dict):
            return randomized(build_model(dict(cfg)), seed)
        return randomized(SegNeXt(**SEGNEXT), seed)

    flat = params_to_jax(make().state_dict())
    flat.pop(NMF_KEY, None)

    def jmake():
        variables = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
        variables.setdefault("state", {})
        return (jbuild(dict(cfg)) if isinstance(cfg, dict) else JSegNeXt(**SEGNEXT)), variables

    return make, jmake


def fake(times, reference=None):
    """Both packages' timers: a time per candidate name; ``reference``, when
    given, is the time of the first call (the unfolded dense reference)."""
    def timer():
        calls = []

        def t(name):
            calls.append(name)
            return reference if reference is not None and len(calls) == 1 else \
                times.get(name, 1.0)
        return t

    jt, t = timer(), timer()
    return (lambda name, m, v, s, d: jt(name)), (lambda name, m, s, d: t(name))


def jax_logits(jmodel, variables, x):
    return np.asarray(jmodel.apply(variables["params"], jnp.asarray(x),
                                   state=variables.get("state", {}), training=False)[0])


def port_logits(model, x):
    with torch.no_grad():
        y = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    return (y.permute(0, 2, 3, 1) if y.dim() == 4 else y).numpy()


def images(shape, seed: int = 3):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- default_candidates --------------------------------------------------------
STRUCTURES = {"ConvNeXt": CONVNEXT, "MSCAN": MSCAN, "SegNeXt": None,
              "AlexNet": dict(type="AlexNet", num_classes=10),
              "ResNet18": dict(type="ResNet", depth=18, num_classes=10),
              "VGG16": dict(type="VGG", depth=16, num_classes=10)}


def structures(name):
    cfg = STRUCTURES[name]
    with torch.device("meta"):  # only the structure is read
        model = build_model(dict(cfg)) if cfg else SegNeXt(**SEGNEXT)
    return (jbuild(dict(cfg)) if cfg else JSegNeXt(**SEGNEXT)), model


@pytest.mark.parametrize("name", sorted(STRUCTURES))
def test_default_candidates_match_jax(name):
    jmodel, model = structures(name)
    want = [n for n, _ in jplanner.default_candidates(jmodel, dtype=jnp.float32)]
    got = [n for n, _ in planner.default_candidates(model)]
    assert got == want and got[0] == "dense/float32"
    for n in got:
        assert planner.recovery_plan(n) == jplanner.recovery_plan(n), n


def test_recovery_plan_matches_jax_for_every_name():
    names = {n for s in STRUCTURES for n, _ in
             jplanner.default_candidates(structures(s)[0], dtype=jnp.float32)}
    names |= {"dense/bfloat16", "dwsep/r=2+int8", "v3/e=0.8"}
    for n in sorted(names):
        for kw in ({}, dict(v3_energy=0.8, dwsep_rank=2)):
            assert planner.recovery_plan(n, **kw) == jplanner.recovery_plan(n, **kw), (n, kw)
    assert planner.recovery_plan("int8") == [dict(qat=True)]


def test_planner_refuses_other_types():
    with pytest.raises(NotImplementedError, match="item 7"):
        planner.default_candidates(structures("MSCAN")[1], dtype=torch.bfloat16)
    make, _ = factories(MSCAN)
    with pytest.raises(NotImplementedError, match="item 7"):
        planner.plan_serving(make, SHAPE, dtype=torch.bfloat16)


# -- plan_serving --------------------------------------------------------------
@pytest.fixture(scope="module")
def convnext_plans():
    """Both planners on the tiny ConvNeXt, over the candidates the fake timer
    names (the pruning candidates add minutes of JAX compiles, not a case)."""
    make, jmake = factories(CONVNEXT)
    jtime, time = fake(FAKE, reference=0.020)
    jcands = [c for c in jplanner.default_candidates(jmake()[0], dtype=jnp.float32)
              if c[0] in FAKE]
    cands = [c for c in planner.default_candidates(make()) if c[0] in FAKE]
    want = jplanner.plan_serving(jmake, SHAPE, dtype=jnp.float32, candidates=jcands,
                                 time_fn=jtime, min_agree=0.0, verbose=False)
    got = planner.plan_serving(make, SHAPE, candidates=cands, time_fn=time, min_agree=0.0,
                               verbose=False)
    return make, want, got


def test_plan_serving_picks_jax_winner(convnext_plans):
    make, want, got = convnext_plans
    assert got["winner"] == want["winner"] == "int8"
    # float32 has two rows named dense/float32: the reference (20 ms) and the
    # candidate (10 ms); JAX's speedup takes the first, the port the candidate
    assert want["speedup_vs_dense"] == pytest.approx(5.0)
    assert got["speedup_vs_dense"] == pytest.approx(2.5)
    keys = ("name", "ms", "img_per_s", "qualified", "note")
    assert [{k: r[k] for k in keys} for r in got["report"]] == \
        [{k: r[k] for k in keys} for r in want["report"]]
    for r in got["report"][1:]:
        assert 0.0 <= r["agree"] <= 1.0
    x = images(SHAPE)
    y = port_logits(got["model"], x)
    assert y.shape == (SHAPE[0], 10) and np.isfinite(y).all()
    assert any(type(m).__name__ == "QuantLinear" for m in got["model"].modules())


def test_min_agree_gate_falls_back_to_dense():
    """No rewritten surface reaches min_agree 1.1: the dense candidate wins
    although the timer calls it the slowest (the JAX test's protocol)."""
    make, _ = factories(CONVNEXT)
    _, time = fake({"dense/float32": 0.010, "int8": 0.001, "v3/e=0.9": 0.001,
                    "dwsep/r=1": 0.001, "dwsep/r=1+int8": 0.001})
    cands = [c for c in planner.default_candidates(make()) if "prune" not in c[0]]
    plan = planner.plan_serving(make, SHAPE, candidates=cands, time_fn=time, min_agree=1.1,
                                verbose=False)
    assert plan["winner"] == "dense/float32"
    for r in plan["report"][2:]:
        assert not r["qualified"] and "needs_recovery" in r["note"]


# -- persisted plans -----------------------------------------------------------
def test_reuse_plan_replays_the_winner_without_timing(convnext_plans):
    make, _, plan = convnext_plans
    stored = json.loads(json.dumps(planner.plan_to_json(plan)))
    assert stored["winner"] == "int8" and "model" not in stored

    def poisoned(*a, **k):
        raise AssertionError("reuse_plan must not time")

    cands = [c for c in planner.default_candidates(make()) if c[0] in ("dense/float32", "int8")]
    again = planner.plan_serving(make, SHAPE, candidates=cands, time_fn=poisoned, min_agree=0.0,
                                 verbose=False, reuse_plan=stored)
    assert again["replayed"] and again["winner"] == "int8" and again["report"] == stored["report"]
    x = images(SHAPE)
    np.testing.assert_array_equal(port_logits(again["model"], x), port_logits(plan["model"], x))

    _, time = fake(dict(FAKE, **{"dense/float32": 0.002}))
    stale = dict(stored, winner="gone/surface")
    fresh = planner.plan_serving(make, SHAPE, candidates=cands, time_fn=time, min_agree=0.0,
                                 verbose=False, reuse_plan=stale)
    assert fresh["winner"] == "dense/float32" and "replayed" not in fresh


def test_reuse_plan_falls_back_when_the_winner_finds_no_target():
    """A persisted v3 winner on a model without a dense kxk conv: the
    reference's replay raises _NoTargets; the port plans again."""
    make, jmake = factories(dict(type="ConvNeXt", num_classes=4, depths=(1, 1, 1, 1),
                                 dims=(4, 4, 4, 4), layer_scale=1.0))
    stored = {"report": [], "winner": "v3/e=0.9", "dtype": "float32", "speedup_vs_dense": 2.0}

    def no_target(*a):
        raise planner._NoTargets("no dense kxk convs")

    def jno_target(*a):
        raise jplanner._NoTargets("no dense kxk convs")

    dense = dict(planner.default_candidates(make()))["dense/float32"]
    jdense = dict(jplanner.default_candidates(jmake()[0], dtype=jnp.float32))["dense/float32"]
    jtime, time = fake({"dense/float32": 0.01})
    with pytest.raises(jplanner._NoTargets):
        jplanner.plan_serving(jmake, SHAPE, dtype=jnp.float32, time_fn=jtime, verbose=False,
                              candidates=[("dense/float32", jdense), ("v3/e=0.9", jno_target)],
                              reuse_plan=stored)
    plan = planner.plan_serving(make, SHAPE, time_fn=time, verbose=False, reuse_plan=stored,
                                candidates=[("dense/float32", dense), ("v3/e=0.9", no_target)])
    assert plan["winner"] == "dense/float32" and "replayed" not in plan
    assert plan["report"][-1]["note"] == "skipped: no dense kxk convs"


# -- the CLI -------------------------------------------------------------------
def test_cli_emits_recovery_configs_the_runner_builds(tmp_path):
    cfg = tmp_path / "tiny_mscan.py"
    cfg.write_text("model = dict(type='MSCAN_Classifier', num_channels=(8, 16),\n"
                   "             num_blocks=(1, 1), exp_ratios=(4, 4), num_classes=7)\n"
                   "seed = 0\n")
    rec = tmp_path / "recovery"
    out = tmp_path / "plan.json"
    args = ["--config", str(cfg), "--batch", "2", "--input-size", "32", "32", "3",
            "--min-agree", "1.01", "--out", str(out), "--emit-recovery", str(rec),
            "--device", "cpu", "--skip", "trunk+,tucker,dwsep"]
    plan = cli.main(args)
    stored = json.loads(out.read_text())
    assert stored["winner"] == plan["winner"] == "dense/float32"  # nothing else qualifies
    lossy = [r["name"] for r in stored["report"][1:]
             if "needs_recovery" in r["note"] or r["name"] == stored["winner"]]
    expected = {f"recover_{n.replace('/', '-').replace('+', '_').replace('=', '')}_stage{i + 1}.py"
                for n in lossy for i, _ in enumerate(jplanner.recovery_plan(n))}
    assert sorted(os.listdir(rec)) == sorted(expected)
    assert any("ffnprune" in e for e in expected) and any("v3" in e for e in expected)
    for name in sorted(expected):
        p = rec / name
        body = p.read_text()
        assert "_base_" in body
        p.write_text(body.replace("num_classes=10)  # FILL", "num_classes=7)")
                     .replace("NUM_CLASSES = 10  # FILL", "NUM_CLASSES = 7"))
        init_cfg(str(p))
        update_cfg(work_dir=str(tmp_path / "work"), config_name=name, seed=0)
        runner = Runner(device="cpu")
        assert runner.model is not None and runner.hooks
    # a second call replays the persisted plan: the same winner, nothing timed
    again = cli.main(args)
    assert again.get("replayed") and again["winner"] == plan["winner"]


def test_cli_refuses_export_and_other_types(tmp_path):
    cfg = tmp_path / "m.py"
    cfg.write_text("model = dict(type='MSCAN_Classifier', num_channels=(8, 16),\n"
                   "             num_blocks=(1, 1), exp_ratios=(4, 4), num_classes=7)\n")
    base = ["--config", str(cfg), "--device", "cpu", "--out", str(tmp_path / "p.json")]
    # --export is ported (tests/test_torch_serve_cli.py); with a type the port does not
    # serve it refuses before anything is planned or written
    art = tmp_path / "a"
    with pytest.raises(NotImplementedError, match="item 7"):
        cli.main(base + ["--export", str(art), "--dtype", "bfloat16", "--batch", "2",
                         "--input-size", "32", "32", "3"])
    assert not art.exists()
    with pytest.raises(NotImplementedError, match="item 7"):
        cli.main(base + ["--dtype", "bfloat16", "--batch", "2", "--input-size", "32", "32", "3"])
