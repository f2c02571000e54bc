"""Tensor parallelism across processes in the port (``parallel/tp.py``,
``parallel/tp_layers.py``, ``parallel/mesh.py::param_shardings``, and
``model_parallel`` in ``L2Reconstruct`` and ``TrainHelper``), on gloo ranks on
the CPU (``tests/torch_ranks.py``), held against the JAX package in this
process (8 CPU devices, ``tests/conftest.py``):

* which parameters each preset shards, and along which dim, for the tiny
  MSCAN and ConvNeXt, ResNet-18, VGG-11, AlexNet and the int8 ResNet-18 tree:
  the JAX ``param_shardings`` spec translated to the port's layout (HWIO ->
  OIHW, ``(in, out)`` -> ``(out, in)``); ``resolve_tp_rules``, the ``^`` and
  ``?`` rules and the typo warning (a port of ``tests/test_parallel.py``);
* the sharded eval forward and the gradients of each family over 2 model
  ranks, and of the tiny MSCAN over (2 data x 2 model), against the JAX
  replicated forward and gradients on the same weights, at the JAX suite's
  tolerances (logits 2e-5; gradients rtol 2e-4, atol 2e-5; VGG/AlexNet rtol
  3e-4, atol 3e-5); every rank holds only its slices; ``MSCA`` keeps its
  fused kernel under the ``mscan`` preset;
* AlexNet's dropouts in training (the sharded hidden activation takes its
  columns of the whole mask); rules no preset has (depthwise taps inside the
  kernel layers, a norm's scale alone); a dim the model axis does not divide
  raises ``ValueError``, as JAX's ``device_put`` does;
* the serving surfaces of ``__graft_entry__``'s ``_tp_parity`` under the
  ``resnet`` preset: int8 ResNet-18 (``qmatmul`` at the column and row shard
  shapes), width-pruned ResNet-18 and the planner's winner;
* ``L2Reconstruct`` with the JAX test's ``TINY_TP_RULES`` over 2 model ranks
  against the JAX hook's own tensor-parallel run (rtol 2e-3, atol 2e-5,
  ``tests/test_finetune.py``) and against one process; ``TrainHelper`` on
  ResNet-18 under the ``resnet`` preset over (1 x 2) and (2 x 2) against one
  process, its checkpoints (npz and sharded) holding the whole model in the
  JAX layout, loaded at world size 1, into the JAX ResNet-18, and resumed
  over the ranks.
"""

import logging
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_ranks  # noqa: E402
from convnet_approximater_tpu import models as jmodels  # noqa: E402
from convnet_approximater_tpu.hooks import HOOK as JHOOK  # noqa: E402
from convnet_approximater_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from convnet_approximater_tpu.parallel import param_shardings as jparam_shardings  # noqa: E402
from convnet_approximater_tpu.parallel import tp as jtp  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from convnet_approximater_tpu_torch.parallel import tp  # noqa: E402
from convnet_approximater_tpu_torch.utils import load_flat  # noqa: E402
from tests.test_finetune import TINY_TP_RULES  # noqa: E402
from tests.test_torch_data_parallel_training import L2_CFG  # noqa: E402  (the JAX TinyBNNet)
from tests.test_torch_finetune import ATOL, STEP_TOL, rel, run_jax  # noqa: E402

torch.set_num_threads(1)
FAMILIES = ("mscan", "convnext", "resnet", "vgg", "alexnet")
GRAD_TOL = {"vgg": (3e-4, 3e-5), "alexnet": (3e-4, 3e-5)}  # tests/test_parallel.py
TOL = {f: dict(y=2e-5, g_rtol=GRAD_TOL.get(f, (2e-4, 2e-5))[0],
               g_atol=GRAD_TOL.get(f, (2e-4, 2e-5))[1]) for f in FAMILIES}
HELPER = dict(batch_size=8, image_size=(32, 32), num_classes=16, epochs=2, max_steps_per_epoch=2,
              max_eval_batches=1, log_interval=1, use_mesh=True, opt="sgd", lr=0.02,
              momentum=0.9, sched=None, clip_grad=1.0, clip_mode="norm", seed=0,
              model_parallel=2, tp_rules="resnet")
# adaptive clipping, whose unit-wise norms of a row shard sum over the model group
AGC = dict(HELPER, epochs=1, clip_mode="agc", clip_grad=0.01)
TRAIN_TOL = 1e-4  # a TP run against one process after 4 SGD steps (sums in another order)


def jax_family(name):
    spec_mscan, spec_convnext = torch_ranks.TINY_MSCAN, torch_ranks.TINY_CONVNEXT
    return {"mscan": lambda: jmodels.MSCAN_Classifier(**spec_mscan),
            "convnext": lambda: jmodels.ConvNeXt(**spec_convnext),
            "resnet": lambda: jmodels.ResNet(depth=18, num_classes=16),
            "vgg": lambda: jmodels.VGG(depth=11, num_classes=16),
            "alexnet": lambda: jmodels.AlexNet(num_classes=16)}[name]()


def port_weights(name, seed=0):
    """The port model of ``name`` with random weights (layer scales 1,
    running statistics of order 1) and its flat JAX-layout tree."""
    from convnet_approximater_tpu_torch.nn import init_weights

    model = torch_ranks.tp_build(name)
    init_weights(model, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for key, t in model.state_dict().items():
            if "layer_scale" in key or key.endswith("gamma"):
                t.fill_(1.0)
            elif key.endswith("running_var"):
                t.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif key.endswith("running_mean"):
                t.copy_(torch.from_numpy((0.1 * rs.randn(*t.shape)).astype(np.float32)))
    return model, params_to_jax(model.state_dict())


def jax_reference(name, flat, x, labels):
    """The JAX model's eval logits and the gradients of its mean cross-entropy."""
    jmodel = jax_family(name)
    variables = jser.unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    state = variables.get("state", {})

    def fwd(params, xx):
        y, _, _ = jmodel.apply(params, xx, state=state, training=False)
        return y

    def loss(params):
        y = fwd(params, x)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(y) * jax.nn.one_hot(labels, y.shape[-1]), -1))

    y = jax.jit(fwd)(variables["params"], x)
    grads = jax.jit(jax.grad(loss))(variables["params"])
    out = {"logits": np.asarray(y)}
    out.update({f"grads/{k}": np.asarray(v)
                for k, v in jser.flatten_tree({"params": grads}).items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_parallel")
    families, xs, labels = {}, {}, {}
    for i, name in enumerate(FAMILIES):
        b, h, w = torch_ranks.TP_INPUT[name]
        rs = np.random.RandomState(10 + i)
        xs[name] = rs.randn(b, h, w, 3).astype(np.float32)
        labels[name] = np.arange(b) % 16
        _, flat = port_weights(name)
        np.savez(d / f"{name}.npz", **flat)
        np.savez(d / f"{name}_jax.npz", **jax_reference(name, flat, xs[name], labels[name]))
        families[name] = (str(d / f"{name}.npz"), str(d / f"{name}_jax.npz"))
    # the JAX L2Reconstruct replicated over its 8-device mesh, and its weights after
    # Optimize, which the port's runs (sharded by TINY_TP_RULES) load
    extra = f", model_parallel=2, tp_rules={TINY_TP_RULES}"
    jrunner, _ = run_jax(d, L2_CFG.format(first='dict(type="SnapshotForPort", priority=10), ',
                                          extra=""), "jax_l2")
    weights = str(d / "after_optimize.npz")
    np.savez(weights, **JHOOK.get("SnapshotForPort").flat)
    port_cfg = d / "port_l2.py"
    port_cfg.write_text(L2_CFG.format(
        first=f'dict(type="LoadFlat", priority=10, path={weights!r}), ', extra=extra))
    helper_runs = dict(run=dict(HELPER, work_dir=str(d / "run")),
                       first=dict(HELPER, epochs=1, ckpt_backend="sharded",
                                  work_dir=str(d / "first")),
                       agc=dict(AGC, work_dir=str(d / "agc")))
    ranks = torch_ranks.spawn(torch_ranks.tp_job, 2, d / "ranks", families=families, x=xs,
                              labels=labels, tol=TOL)
    train = torch_ranks.spawn(
        torch_ranks.tp_train_job, 2, d / "train",
        l2=dict(cfg=str(port_cfg), work=str(d / "l2_world2")),
        helper=dict(weights=families["resnet"][0], runs=helper_runs))
    resumed = dict(HELPER, resume=os.path.join(str(d / "first"), "last.ckpt.dcp"),
                   work_dir=str(d / "resumed"))
    dp = torch_ranks.spawn(torch_ranks.tp_dp_job, 4, d / "dp",
                           families={"mscan": families["mscan"]}, x=xs, labels=labels, tol=TOL,
                           helper=dict(weights=families["resnet"][0],
                                       runs=dict(run=dict(HELPER, work_dir=str(d / "dp_run")))),
                           resumed=dict(weights=families["resnet"][0], cfg=resumed))
    one = dict(l2=torch_ranks.l2_run(str(port_cfg), str(d / "l2_world1")),
               **{k: torch_ranks.helper_run(
                   torch_ranks.tp_model("resnet", families["resnet"][0]).train(),
                   dict(cfg, work_dir=str(d / f"one_{k}")))
                  for k, cfg in (("helper", HELPER), ("agc", AGC))})
    return dict(ranks=ranks, train=train, dp=dp, one=one, jax_l2=jrunner, dir=d)


# -- the layouts (no ranks) ----------------------------------------------------
def expected_dims(jspecs: dict, port: dict) -> dict:
    """The JAX specs of ``jspecs`` (JAX path: spec) as the port's sharded dim
    per parameter of ``port`` (name: tensor), translated independently of the
    port's own translation."""
    out = {}
    for name, t in port.items():
        key = next(iter(params_to_jax({name: t.detach()})))[len("params/"):]
        spec = tuple(jspecs[key].spec)
        js = [j for j, a in enumerate(spec) if a == "model"]
        if not js:
            out[name] = None
            continue
        j, leaf = js[0], name.rsplit(".", 1)[-1]
        if leaf in ("weight", "weight_q") and t.dim() == 4:
            out[name] = {3: 0, 2: 1, 0: 2, 1: 3}[j]
        elif leaf in ("weight", "weight_q") and t.dim() == 2:
            out[name] = 1 - j
        else:
            out[name] = j
    return out


def int8_resnet_trees():
    """The int8 ResNet-18 of both packages (fold, then quantize on calibration batches)."""
    from convnet_approximater_tpu.deploy import fold_batchnorm as jfold
    from convnet_approximater_tpu.deploy import quantize_int8 as jquantize
    from convnet_approximater_tpu_torch import deploy

    m = jmodels.ResNet(depth=18, num_classes=8)
    v = {"params": m.init(jax.random.key(0)), "state": m.init_state()}
    jfold(m, v)
    assert jquantize(m, v, [jax.random.normal(jax.random.key(1), (2, 32, 32, 3))]) > 0
    model = torch_ranks.tp_build("resnet").eval()
    deploy.fold_batchnorm(model)
    x = torch_ranks.nchw(np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32))
    assert deploy.quantize_int8(model, [x]) > 0
    return v["params"], dict(model.named_parameters())


@pytest.mark.parametrize("family", FAMILIES + ("int8",))
def test_preset_shards_the_leaves_jax_shards(family):
    jmesh = jmake_mesh(data=4, model=2)
    if family == "int8":
        jparams, port = int8_resnet_trees()
        rules_j, rules_t = jtp.resnet_tp_rules(), tp.resnet_tp_rules()
    else:
        jmodel = jax_family(family)
        jparams = jax.eval_shape(lambda: jmodel.init(jax.random.key(0)))  # the paths alone
        port = dict(torch_ranks.tp_build(family).named_parameters())
        rules_j, rules_t = jtp.resolve_tp_rules(family), tp.resolve_tp_rules(family)
    jspecs = jser.flatten_tree(jparam_shardings(jparams, jmesh, rules_j, warn=False))
    assert set(jspecs) == {next(iter(params_to_jax({n: t.detach()})))[len("params/"):]
                           for n, t in port.items()}
    got = tmesh.param_shardings(port, None, rules_t, warn=False)
    want = expected_dims(jspecs, port)
    assert got == want
    assert any(d is not None for d in got.values())
    if family == "int8":  # test_parallel.py::test_int8_tp_aliases_shard_quantized_tree
        assert got["layer1.0.conv1.weight_q"] == 0 and got["layer1.0.conv1.w_scale"] == 0
        assert got["layer1.0.conv2.weight_q"] == 1 and got["layer1.0.conv2.w_scale"] is None
        assert got["conv1.weight_q"] is None and got["conv1.bias"] is None
        assert got["fc.weight_q"] == 0


def test_resolve_tp_rules_and_the_typo_warning():
    # None and "" mean the mscan preset; the presets are the JAX package's, as tuples
    assert tp.resolve_tp_rules(None) == tp.resolve_tp_rules("") == tp.mscan_tp_rules()
    for name in FAMILIES:
        assert tp.resolve_tp_rules(name) == [(s, tuple(p)) for s, p in jtp.resolve_tp_rules(name)]
    with pytest.raises(KeyError) as te:
        tp.resolve_tp_rules("nope")
    with pytest.raises(KeyError) as je:
        jtp.resolve_tp_rules("nope")
    assert str(te.value) == str(je.value)
    explicit = [["head/weight", [None, "model"]], ("head/bias", ("model",))]
    assert tp.resolve_tp_rules(explicit) == [("head/weight", (None, "model")),
                                             ("head/bias", ("model",))]
    # test_parallel.py::test_param_shardings_unmatched_rule_warns
    records = torch_ranks.Records()
    try:
        params = {"head.weight": torch.zeros(8, 4), "head.bias": torch.zeros(8),
                  "conv1.weight_q": torch.zeros(8, 3, 3, 3, dtype=torch.int8)}
        got = tmesh.param_shardings(params, None, [
            ("head/weight", (None, "model")),
            ("no_such_module/weight", (None, "model")),  # a typo
            ("?optional/weight", (None, "model")),  # optional: never reported
            ("conv1/weight", (None, None, None, "model")),  # covered by its int8 twin
            ("?conv1/weight_q", (None, None, None, "model"))])
        assert got == {"head.weight": 0, "head.bias": None, "conv1.weight_q": 0}
        warned = " ".join(records.messages)
        assert "tp rules matched no params (typo?)" in warned
        assert "no_such_module/weight" in warned and "optional" not in warned
        assert "'conv1/weight'" not in warned and "'head/weight'" not in warned
        records.messages.clear()
        tmesh.param_shardings(params, None, [("no_such_module/weight", (None, "model"))],
                              warn=False)
        assert not records.messages
        # ^ pins the full path: the root's conv1 only
        got = tmesh.param_shardings({"conv1.weight": torch.zeros(4, 3, 3, 3),
                                     "layer1.0.conv1.weight": torch.zeros(4, 4, 3, 3)}, None,
                                    [("^conv1/weight", ()),
                                     ("conv1/weight", (None, None, None, "model"))])
        assert got == {"conv1.weight": None, "layer1.0.conv1.weight": 0}
    finally:
        logging.getLogger("convnet_approximater_tpu_torch").removeHandler(records)


# -- the sharded forward and gradients -------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_forward_and_gradients_match_jax(runs, family):
    for r in runs["ranks"]:
        got = r[family]
        assert got["y"] <= 1.0, got["y"]
        bad = {n: v for n, v in got["grads"].items() if v > 1.0}
        assert not bad, bad
        assert got["held"]  # every sharded parameter is this rank's slice alone
        assert got["bytes"][0] < got["bytes"][1]
    roles = runs["ranks"][0][family]["roles"]
    pairs = {"mscan": ("mlp.fc1", "mlp.dconv", "mlp.fc2"), "convnext": ("pwconv1", "pwconv2"),
             "resnet": ("conv1", "bn1", "conv2"), "vgg": ("classifier.0", "classifier.3"),
             "alexnet": ("classifier.1", "classifier.4")}[family]
    want = ["col"] + ["local"] * (len(pairs) - 2) + ["row"]
    for name, role in zip(pairs, want):
        found = [v for k, v in roles.items() if k == name or k.endswith("." + name)]
        assert found and all(v == role for v in found), (name, found)
    if family == "mscan":  # every MSCA still runs msca_fused, its mix gathered whole
        calls, blocks = runs["ranks"][0]["mscan"]["fused"]
        assert calls == blocks == sum(torch_ranks.TINY_MSCAN["num_blocks"])


def test_data_and_model_axes_together(runs):
    """(2 data x 2 model): each data rank's rows of the tiny MSCAN's logits and the
    global batch's gradients against JAX."""
    for r in runs["dp"]:
        got = r["mscan"]
        assert got["y"] <= 1.0 and got["held"]
        bad = {n: v for n, v in got["grads"].items() if v > 1.0}
        assert not bad, bad


def test_dropout_masks_and_refusals(runs):
    for r in runs["ranks"]:
        got = r["dropout"]
        np.testing.assert_allclose(got["y"].numpy(), got["whole"].numpy(), rtol=2e-5, atol=2e-6)
        assert got["slices"][3] == (-1, r["dropout"]["slices"][3][1], 2)  # between fc1 and fc2
        assert got["slices"][0] is None  # on the replicated input
        msg = r["uneven"]
        assert "should be divisible by 2, but it is equal to 5" in msg
        assert r["spatial"] == (True, True, True)  # laid out spatially, then its TP form again
        assert "spatially sharded model" in r["spatial_then_tp"] and "12b" in r["spatial_then_tp"]
    assert [r["dropout"]["slices"][3][1] for r in runs["ranks"]] == [0, 1]
    # JAX refuses the same layout at device_put
    from jax.sharding import NamedSharding, PartitionSpec as P

    with pytest.raises(ValueError, match="should be divisible by 2, but it is equal to 5"):
        jax.device_put(np.zeros((4, 5), np.float32),
                       NamedSharding(jmake_mesh(data=4, model=2), P(None, "model")))


def test_rules_no_preset_has(runs):
    """Any rule list gives the replicated forward: depthwise taps inside the kernel
    layers column-sharded (the fused kernel takes them gathered), a norm's scale
    sharded alone (the layer gathers it)."""
    for r in runs["ranks"]:
        got = r["explicit"]
        assert got["roles"] == ["col", "gathered"]
        for y, ref in (got["fused"], got["module"]):
            np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("surface", ["int8", "pruned", "planner"])
def test_deploy_surfaces_under_the_resnet_preset(runs, surface):
    for r in runs["ranks"]:
        got = r["deploy"][surface]
        y, ref = got["y"].numpy(), got["ref"].numpy()
        if surface == "pruned":  # float sums split over the ranks: __graft_entry__'s bound
            assert np.max(np.abs(y - ref)) < 1e-4 * max(1.0, np.max(np.abs(ref)))
        else:  # int8: a row shard sums exact integer partials, so the bits are the replicated's
            assert np.array_equal(y, ref)
            whole, sharded = got["row"]  # layer1's conv2 (row-sharded) itself, bit for bit
            assert torch.equal(whole, sharded)
        assert "col" in got["roles"].values() and "row" in got["roles"].values()
    got = runs["ranks"][0]["deploy"][surface]
    calls = [(x[1], w[0]) for x, w in got["qmatmul"]]  # qmatmul's (K, N) per call
    if surface == "int8":
        assert len(calls) == got["info"]  # one call per int8 layer
        assert (64 * 9, 32) in calls  # layer1's conv1: N / 2 (column)
        assert (32 * 9, 64) in calls  # layer1's conv2: K / 2 (row)
        assert (512, 8) in calls  # fc: N / 2
    elif surface == "planner":
        assert got["info"] == "trunk+chainprune/0.5+int8" and calls
    else:
        assert got["info"][0] > 0 and got["info"][1] > 0 and not calls


# -- training ----------------------------------------------------------------
def test_l2reconstruct_with_tiny_tp_rules(runs):
    ranks, one = runs["train"], runs["one"]["l2"]
    jflat = jser.flatten_tree(runs["jax_l2"].variables)
    for r in ranks:
        assert all(torch.equal(v, ranks[0]["l2"]["state"][k])
                   for k, v in r["l2"]["state"].items())
    got = params_to_jax(ranks[0]["l2"]["state"])
    for k, v in got.items():
        if k.startswith("params/"):  # tests/test_finetune.py::test_finetune_dp_tp_matches_dp
            np.testing.assert_allclose(v, np.asarray(jflat[k]), rtol=2e-3, atol=2e-5, err_msg=k)
    want = params_to_jax(one["state"])
    for k, v in got.items():
        assert rel(v, want[k]) <= STEP_TOL or np.max(np.abs(v - want[k])) <= ATOL, k
    np.testing.assert_allclose(ranks[0]["l2"]["steps"], one["steps"], rtol=STEP_TOL, atol=ATOL)


def close_trees(got: dict, want: dict, tol=TRAIN_TOL):
    got, want = params_to_jax(got), params_to_jax(want)
    assert set(got) == set(want)
    for k in want:
        assert np.all(np.abs(got[k] - want[k]) <= tol * np.abs(want[k]) + 1e-6), (
            k, np.max(np.abs(got[k] - want[k])))


@pytest.mark.parametrize("world", ["model2", "data2_model2", "model2_agc"])
def test_trainhelper_under_the_resnet_preset(runs, world):
    ranks = runs["dp"] if world == "data2_model2" else runs["train"]
    one = runs["one"]["agc" if world.endswith("agc") else "helper"]
    if world.endswith("agc"):
        ranks = [dict(r, run=r["agc"]) for r in ranks]
    # each step's global loss: the mean of the data ranks' rows (each data rank's model
    # ranks hold the same rows)
    np.testing.assert_allclose(np.mean([r["run"]["steps"] for r in ranks], axis=0),
                               one["steps"], rtol=TRAIN_TOL)
    for r in ranks:
        got = r["run"]
        close_trees(got["state"], one["state"])
        assert all(torch.equal(v, ranks[0]["run"]["state"][k]) for k, v in got["state"].items())
        held = got["held"]
        assert held["bytes"][0] < sum(v.numel() * 4 for k, v in one["state"].items()
                                      if "running" not in k)
        assert "layer1.0.bn1.running_mean" in held["sharded"]
        assert held["opt"]["layer1.0.conv1.weight"][0] == 32  # the moments are the shard's
        assert held["opt"]["conv1.weight"][0] == 64  # the stem stays whole


def test_tp_checkpoints_hold_the_whole_model(runs):
    d = runs["dir"]
    final = runs["train"][0]["run"]["state"]
    for path in (os.path.join(str(d / "run"), "last.ckpt.npz"),
                 os.path.join(str(d / "first"), "last.ckpt.dcp")):
        flat = load_flat(path)
        model = torch_ranks.tp_build("resnet")
        state = params_from_jax({k: v for k, v in flat.items()
                                 if k.split("/")[0] in ("params", "state")})
        model.load_state_dict(state)  # strict: the whole model at world size 1
        opt = {k for k in flat if k.startswith("opt/layer1.0.conv1.weight/")}
        assert opt and all(flat[k].shape[0] == 64 for k in opt if not k.endswith("count"))
        jmodel = jmodels.ResNet(depth=18, num_classes=16)
        jparams = jser.flatten_tree({"params": jax.eval_shape(
            lambda: jmodel.init(jax.random.key(0)))})
        assert {k: np.shape(v) for k, v in jparams.items()} == {
            k: np.shape(v) for k, v in flat.items() if k.startswith("params/")}
    npz = params_from_jax({k: v for k, v in load_flat(
        os.path.join(str(d / "run"), "last.ckpt.npz")).items() if k.split("/")[0] in
        ("params", "state")})
    assert all(torch.equal(npz[k], v) for k, v in final.items())
    # resumed over (2 x 2) from the sharded checkpoint of epoch 0: the uninterrupted run
    for r in runs["dp"]:
        close_trees(r["resumed"]["state"], final)
