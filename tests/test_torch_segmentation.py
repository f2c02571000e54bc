"""The port's segmentation (``convnet_approximater_tpu_torch/segmentation/``)
against the JAX package's, on the CPU.

The same numpy inputs from a seed go through both packages:

* ``GroupNorm`` within 1e-5; ``nmf2d`` and ``Hamburger`` within 1e-4
  (relative norm: seven multiplicative updates, each a ratio of two float32
  products), with JAX's dictionary draw carried into the port's ``nmf_init``
  buffer, and the gradient that the one differentiated update carries to
  ``ham_in``;
* ``resize_bilinear`` against ``jax.image.resize`` at factors 2, 4, 8 and a
  non-integer one, all enlargements, as on every path here (1e-6);
* the tiny SegNeXt of the JAX tests (channels 8/12/16/20, blocks 1/1/2/1, 7
  classes, ham 16, rank 4, 3 iterations), layer scales 1 and random BN, dense
  and after MscaRep(1, fix) in each package: logits within 1e-4;
* ``seg_cross_entropy`` with ignore, class weights, resize-in-loss and the
  all-ignored batch (0, not NaN) within 1e-5; ``confusion_matrix`` and
  ``iou_from_confusion`` exact; ``SyntheticSeg`` bit for bit;
* one ``SegL2Reconstruct`` step of both Runners from the same weights (asym,
  L2 + CE + KD over the class axis of the NCHW logits, sgd, drop rates 0):
  loss, CE, L2 norm and the gradient norm (the
  first sgd update over the learning rate) within 1e-4, and the validation's
  loss, mIoU and aAcc;
* the port's CLI on tiny copies of both SegNeXt configs (``--device cpu``);
* ``prune_trunks`` on SegNeXt (the JAX ``tests/test_prune_trunks.py`` case):
  widths, every tensor and the logits;
* the ``Loader`` refusing augmentation with dense labels.
"""

import os
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu import deploy as jdeploy  # noqa: E402
from convnet_approximater_tpu import segmentation as jseg  # noqa: E402
from convnet_approximater_tpu.core import MscaRep as JMscaRep  # noqa: E402
from convnet_approximater_tpu.deploy_planner import apply_app as japply  # noqa: E402
from convnet_approximater_tpu.hooks import HOOK as JHOOK  # noqa: E402
from convnet_approximater_tpu.hooks import Hook as JHook  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree, unflatten_tree  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch import segmentation as seg  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import MscaRep  # noqa: E402
from convnet_approximater_tpu_torch.data import Loader  # noqa: E402
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.hooks import HOOK, Hook  # noqa: E402
from convnet_approximater_tpu_torch.layers import MSCA  # noqa: E402
from convnet_approximater_tpu_torch.nn import GroupNorm, channels_last, init_weights  # noqa: E402
from tests.test_torch_finetune import recording, rel, summary  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
NMF_RTOL = 1e-4
LOGITS_RTOL = 1e-4
STEP_TOL = 1e-4
TINY = dict(num_channels=(8, 12, 16, 20), num_blocks=(1, 1, 2, 1), exp_ratios=(2, 2, 2, 2),
            num_classes=7, ham_channels=16, ham_rank=4, ham_iters=3)
NMF_KEY = "state/decode_head/hamburger/nmf_init"


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def nhwc(y):
    return y.permute(0, 2, 3, 1).detach().numpy()


def jax_draw(channels, rank):
    """The JAX head's dictionary start (``ham_head.py:63``)."""
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(42), (1, channels, rank),
                                         jnp.float32, 1e-3, 1.0))


def to_jax(model):
    """The port model's variables as the JAX package's tree, without the
    dictionary draw (the JAX package stores none)."""
    flat = params_to_jax(model.state_dict())
    flat.pop(NMF_KEY, None)
    return unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})


def tiny_dense(**kw):
    """The tiny SegNeXt with random weights, random BN statistics and norm
    affines, layer scales 1, and JAX's dictionary draw."""
    model = seg.SegNeXt(**dict(TINY, **kw))
    init_weights(model, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if "layer_scale" in name:
                t.fill_(1.0)
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif name.endswith("running_mean") or "norm" in name:
                t.add_(torch.from_numpy((0.3 * rs.randn(*t.shape)).astype(np.float32)))
        model.decode_head.hamburger.nmf_init.copy_(
            torch.from_numpy(jax_draw(model.decode_head.hamburger.ham_in.in_channels,
                                      model.decode_head.hamburger.rank)))
    return channels_last(model).eval()


def jax_logits(jmodel, variables, x):
    return np.asarray(jax.jit(lambda p, s, x: jmodel.apply(p, x, state=s)[0])(
        variables["params"], variables.get("state", {}), jnp.asarray(x)))


# -- layers -------------------------------------------------------------------
def test_group_norm_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 7, 12).astype(np.float32) * 3 + 1
    params = {"scale": rs.randn(12).astype(np.float32), "bias": rs.randn(12).astype(np.float32)}
    y_j = np.asarray(jnn.GroupNorm(4, 12).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))[0])
    gn = GroupNorm(4, 12)
    gn.load_state_dict(params_from_jax({f"params/{k}": v for k, v in params.items()}))
    with torch.no_grad():
        y = nhwc(gn(nchw(x)))
    assert rel(y, y_j) < RTOL


def test_nmf_draw_is_fixed_and_in_range():
    a, b = seg.nmf_draw(16, 4), seg.nmf_draw(16, 4)
    assert torch.equal(a, b) and a.shape == (1, 16, 4)
    assert float(a.min()) >= 1e-3 and float(a.max()) < 1.0
    assert torch.equal(seg.Hamburger(16, rank=4).nmf_init, a)


@pytest.mark.parametrize("iters", [3, 6])
def test_nmf2d_matches_jax_with_the_carried_draw(iters):
    x = np.random.RandomState(iters).randn(2, 36, 12).astype(np.float32)
    y_j = np.asarray(jseg.nmf2d(jnp.asarray(x), rank=4, iters=iters))
    y = seg.nmf2d(torch.from_numpy(x), torch.from_numpy(jax_draw(12, 4)), iters)
    assert y.shape == x.shape and bool((y >= 0).all())
    assert rel(y.numpy(), y_j) < NMF_RTOL


def test_hamburger_and_its_gradient_to_ham_in_match_jax():
    """Forward, and the gradient of a loss of the output with respect to
    ``ham_in``'s weight, which only the differentiated last update carries."""
    C, rank = 16, 4
    jham = jseg.Hamburger(C, rank=rank, iters=3)
    rs = np.random.RandomState(3)
    params = {"ham_in": {"weight": rs.uniform(-0.5, 0.5, (1, 1, C, C)).astype(np.float32)},
              "ham_out": {"weight": rs.uniform(-0.5, 0.5, (1, 1, C, C)).astype(np.float32)},
              "norm": {"scale": rs.uniform(0.5, 1.5, C).astype(np.float32),
                       "bias": rs.randn(C).astype(np.float32)}}
    x = rs.randn(2, 6, 5, C).astype(np.float32)
    w = rs.randn(2, 6, 5, C).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)

    def jloss(p):
        return jnp.sum(jham.apply(p, jnp.asarray(x))[0] * w)

    y_j = np.asarray(jham.apply(jp, jnp.asarray(x))[0])
    g_j = np.asarray(jax.grad(jloss)(jp)["ham_in"]["weight"])  # HWIO

    flat = {f"params/{k}": v for k, v in flatten_tree(params).items()}
    flat["state/nmf_init"] = jax_draw(C, rank)
    ham = seg.Hamburger(C, rank=rank, iters=3)
    ham.load_state_dict(params_from_jax(flat))
    y = ham(nchw(x))
    (y * nchw(w)).sum().backward()
    g = ham.ham_in.weight.grad.permute(2, 3, 1, 0).numpy()
    assert rel(nhwc(y), y_j) < NMF_RTOL
    assert np.abs(g).sum() > 0 and rel(g, g_j) < NMF_RTOL


@pytest.mark.parametrize("size,to", [((5, 7), (10, 14)), ((4, 6), (16, 24)), ((3, 5), (24, 40)),
                                     ((5, 4), (13, 11))])
def test_resize_bilinear_matches_jax_when_it_enlarges(size, to):
    x = np.random.RandomState(sum(to)).randn(2, *size, 3).astype(np.float32)
    y_j = np.asarray(jseg.resize_bilinear(jnp.asarray(x), to))
    y = nhwc(seg.resize_bilinear(nchw(x), to))
    np.testing.assert_allclose(y, y_j, rtol=1e-6, atol=1e-6)


# -- the model ------------------------------------------------------------------
@pytest.mark.parametrize("rep", [False, True], ids=["dense", "mscarep_d1_fix"])
def test_segnext_logits_match_jax(rep):
    model = tiny_dense()
    jmodel = jseg.SegNeXt(**TINY)
    jv = to_jax(model)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    if rep:
        assert japply(jmodel, jv, JMscaRep(decomp=1, fix=True), [], jax.random.key(0)) == 5
        assert apply_app(model, MscaRep(decomp=1, fix=True)) == 5
        assert model.switchable_names[0].startswith("backbone.")
    y_j = jax_logits(jmodel, jv, x)
    with torch.no_grad():
        if rep:
            assert all(m.can_fuse() for m in model.modules() if isinstance(m, MSCA))
        y = model(nchw(x))
    assert y.shape == (2, 7, 8, 8) and y.is_contiguous(memory_format=torch.channels_last)
    assert rel(nhwc(y), y_j) < LOGITS_RTOL
    model.full_res = True
    with torch.no_grad():
        assert model(nchw(x)).shape == (2, 7, 64, 64)


def test_segnext_training_forward_differentiates_to_the_head():
    model = tiny_dense().train()
    y = model(nchw(np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32)))
    seg.seg_cross_entropy(y, torch.zeros(2, 32, 32, dtype=torch.long)).backward()
    for name in ("decode_head.hamburger.ham_in.weight", "decode_head.squeeze.weight",
                 "backbone.layers.1.1.0.attn.spatial_gating_unit.conv0.weight"):
        assert float(model.get_parameter(name).grad.abs().sum()) > 0, name


# -- loss, metrics, data ----------------------------------------------------------
LOSS_CASES = {  # (logits size, labels size, ignore fraction, class weights)
    "plain": ((8, 8), (8, 8), 0.0, None),
    "ignore": ((8, 8), (8, 8), 0.3, None),
    "weights": ((8, 8), (8, 8), 0.2, (0.5, 1.0, 2.0, 0.1, 1.5)),
    "resize": ((4, 5), (16, 20), 0.2, None),
    "all_ignored": ((4, 4), (8, 8), 1.0, None),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_seg_cross_entropy_matches_jax(case):
    (h, w), (H, W), ignore, weights = LOSS_CASES[case]
    rs = np.random.RandomState(len(case))
    logits = (3 * rs.randn(2, h, w, 5)).astype(np.float32)
    labels = rs.randint(0, 5, (2, H, W)).astype(np.int64)
    labels[rs.rand(2, H, W) < ignore] = 255
    l_j = float(jseg.seg_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                       class_weights=weights))
    lt = nchw(logits).requires_grad_(True)
    loss = seg.seg_cross_entropy(lt, torch.from_numpy(labels), class_weights=weights)
    loss.backward()
    assert np.isfinite(float(loss)) and abs(float(loss) - l_j) <= RTOL * abs(l_j) + 1e-7
    if case == "all_ignored":
        assert float(loss) == 0.0 and float(lt.grad.abs().sum()) == 0.0


def test_confusion_matrix_and_iou_match_jax_exactly():
    rs = np.random.RandomState(0)
    label = rs.randint(0, 6, (3, 17, 19))
    label[rs.rand(*label.shape) < 0.1] = 255
    pred = rs.randint(0, 6, label.shape)
    cm_j = np.asarray(jseg.confusion_matrix(jnp.asarray(pred), jnp.asarray(label), 6))
    cm = seg.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), 6)
    assert cm.dtype == torch.int64
    np.testing.assert_array_equal(cm.numpy(), cm_j)
    s, s_j = seg.iou_from_confusion(cm.numpy()), jseg.iou_from_confusion(cm_j)
    assert set(s) == set(s_j)
    for k in s:
        np.testing.assert_array_equal(s[k], s_j[k])
    small = seg.confusion_matrix(torch.tensor([[0, 1, 1, 1, 0]]), torch.tensor([[0, 0, 1, 1, 255]]), 2)
    assert small.tolist() == [[1, 1], [0, 2]]


@pytest.mark.parametrize("kw", [dict(), dict(ignore_border=True, grid=3, seed=5, split="validation")])
def test_synthetic_seg_matches_jax_bit_for_bit(kw):
    a = seg.SyntheticSeg(6, (16, 20), num_classes=5, **kw)
    b = jseg.SyntheticSeg(6, (16, 20), num_classes=5, **kw)
    assert a.images.dtype == b.images.dtype and a.labels.dtype == b.labels.dtype
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.num_classes == b.num_classes == 5


def test_loader_refuses_aug_with_dense_labels():
    ds = seg.SyntheticSeg(4, (8, 8), num_classes=3)
    with pytest.raises(ValueError, match="masks"):
        Loader(ds, 2, device="cpu", aug=dict(hflip=0.5))
    assert len(Loader(ds, 2, device="cpu")) == 2  # no aug: accepted


# -- the fine-tune ----------------------------------------------------------------
class Snap:
    """Flat variables of each package's run, before and after fine-tuning."""
    jax_before = jax_after = port_before = port_after = None


if "SegSnapBefore" not in JHOOK:

    @JHOOK.register_module()
    class SegSnapBefore(JHook):
        """Sets the head's dropout to 0 (no config key reaches it) and keeps the
        JAX runner's variables as they stand before fine-tuning."""

        def after_optimize(self):
            self.runner.model.decode_head.drop.p = 0.0
            Snap.jax_before = {k: np.asarray(v).copy()
                               for k, v in flatten_tree(self.runner.variables).items()}

    @JHOOK.register_module()
    class SegSnapAfter(JHook):
        def after_optimize(self):
            Snap.jax_after = {k: np.asarray(v).copy()
                              for k, v in flatten_tree(self.runner.variables).items()}


if "SegLoadFromJax" not in HOOK:

    @HOOK.register_module()
    class SegLoadFromJax(Hook):
        """Loads the JAX variables from before fine-tuning, with JAX's
        dictionary draw, into the port's model and sets its head's dropout to 0."""

        def after_optimize(self):
            model = self.runner.model
            flat = dict(Snap.jax_before)
            flat[NMF_KEY] = jax_draw(TINY["ham_channels"], TINY["ham_rank"])
            missing, unexpected = model.load_state_dict(params_from_jax(flat), strict=False)
            assert not missing and not unexpected, (missing, unexpected)
            model.decode_head.drop.p = 0.0

    @HOOK.register_module()
    class SegSnapAfterPort(Hook):
        def after_optimize(self):
            Snap.port_after = params_to_jax(self.runner.model.state_dict())


SEG_FT = """
model = dict(type="SegNeXt", num_channels=(8, 12, 16, 20), num_blocks=(1, 1, 2, 1),
             exp_ratios=(2, 2, 2, 2), num_classes=7, ham_channels=16, ham_rank=4,
             ham_iters=3, drop_rate=0.0, drop_path_rate=0.0)
app = dict(type="MscaRep", decomp=1, fix=True)
filters = []
hooks = [dict(type="{before}", priority=10), dict(type="{after}", priority=60),
         dict(type="SegL2Reconstruct", priority=50, asym=True, l2_weight=1.0, cls_weight=0.5,
              kd_weight=1.0, kd_temperature=2.0, dataset_args=dict(batch_size=4), data_config=dict(image_size=(32, 32)),
              optim_args=dict(opt="sgd", lr={lr}), sche_args=dict(epochs=1),
              other_args=dict(num_classes=7, max_steps_per_epoch=1, max_eval_batches=2,
                              log_interval=1, use_mesh=False))]
"""


def run_seg(tmp_path, text, runner_cls, cfg, name):
    """Run ``text`` through one package's Runner, recording each step's
    (loss, CE, L2 norm)."""
    path = tmp_path / f"{name}.py"
    path.write_text(text)
    cfg.init_cfg(str(path))
    cfg.update_cfg(work_dir=str(tmp_path / name), config_name=name, seed=0)
    runner = runner_cls() if name == "jax" else runner_cls(device="cpu")
    hook = next(h for h in runner.hooks if h.name == "SegL2Reconstruct")
    steps = []
    if name == "jax":
        make = hook._make_train_step
        hook._make_train_step = lambda tx: recording(make(tx), steps, lambda o: o[3:6])
    else:
        hook.train_step = recording(hook.train_step, steps, lambda o: o)
    runner.run()
    return runner, hook, steps


def test_seg_l2reconstruct_step_matches_jax(tmp_path):
    from convnet_approximater_tpu.runner import Runner as JRunner
    from convnet_approximater_tpu.utils import config as jcfg
    from convnet_approximater_tpu_torch.runner import Runner
    from convnet_approximater_tpu_torch.utils import config as tcfg

    lr = 0.05
    _, _, jsteps = run_seg(tmp_path, SEG_FT.format(before="SegSnapBefore", after="SegSnapAfter",
                                                   lr=lr), JRunner, jcfg, "jax")
    _, hook, tsteps = run_seg(tmp_path, SEG_FT.format(before="SegLoadFromJax",
                                                      after="SegSnapAfterPort", lr=lr),
                              Runner, tcfg, "port")
    assert hook.other_args.eval_metric == "miou" and hook.teacher is not None
    assert len(tsteps) == len(jsteps) == 1
    for what, a, b in zip(("loss", "ce", "norm"), tsteps[0], jsteps[0]):
        assert abs(float(a) - b) <= STEP_TOL * abs(b), (what, float(a), b)
    # the first sgd step moves each trainable parameter by lr times its gradient
    before, j_after, t_after = Snap.jax_before, Snap.jax_after, Snap.port_after
    moved = [k for k in j_after if k.startswith("params/") and k in before
             and not np.array_equal(j_after[k], before[k])]
    assert moved and all("/new/" in k for k in moved)  # asym: every new branch trains
    g_j = np.sqrt(sum(np.sum((j_after[k] - before[k]) ** 2) for k in moved)) / lr
    g = np.sqrt(sum(np.sum((t_after[k] - before[k]) ** 2) for k in moved)) / lr
    assert g > 0 and abs(g - g_j) <= STEP_TOL * g_j, (g, g_j)
    js, ts = summary(tmp_path / "jax" / "summary.csv"), summary(tmp_path / "port" / "summary.csv")
    assert set(ts[0]) == set(js[0]) and {"eval_miou", "eval_aacc"} <= set(ts[0])
    assert abs(ts[0]["eval_loss"] - js[0]["eval_loss"]) <= STEP_TOL * js[0]["eval_loss"]
    assert (ts[0]["eval_miou"], ts[0]["eval_aacc"]) == (js[0]["eval_miou"], js[0]["eval_aacc"])


TINY_CFG = """_base_ = [{base!r}]
model = dict(num_channels=(8, 12, 16, 20), num_blocks=(1, 1, 2, 1), exp_ratios=(2, 2, 2, 2),
             num_classes=7, ham_channels=16, ham_rank=4, ham_iters=3)
hooks = [{hook}]
"""
TINY_HOOKS = {
    "msca-rep/msca-rep_d1_fix_segnext-t.py":
        'dict(type="InferenceTimeHook", priority=50, '
        'infer_cfg=dict(input_size=(2, 64, 64, 3), num_iters=2, warmup=1))',
    "msca-rep/finetune/msca-rep-d1-fix_l2-asym_segnext-t.py":
        'dict(type="SegL2Reconstruct", priority=50, asym=True, l2_weight=1.0, cls_weight=1.0, '
        'dataset_args=dict(batch_size=4), data_config=dict(image_size=(32, 32)), '
        'sche_args=dict(epochs=1), optim_args=dict(opt="adamw", lr=1e-4, weight_decay=0.01), '
        'other_args=dict(num_classes=7, eval_metric="miou", max_steps_per_epoch=2, '
        'max_eval_batches=1, log_interval=1))',
}


@pytest.mark.parametrize("name", sorted(TINY_HOOKS))
def test_cli_runs_tiny_segnext_configs_on_cpu(tmp_path, name):
    """A copy of each SegNeXt config with a narrow model and small images."""
    from convnet_approximater_tpu_torch import main as cli

    cfg = tmp_path / "cfg.py"
    cfg.write_text(TINY_CFG.format(base=os.path.join(REPO, "configs", name), hook=TINY_HOOKS[name]))
    work = tmp_path / "run"
    runner = cli.main(["--config", str(cfg), "--device", "cpu", "--seed", "0",
                       "--work-dir", str(work)])
    model = runner.model
    assert type(model).__name__ == "SegNeXt" and model.length_switchable == 5
    log = (work / "run.log").read_text()
    if "finetune" in name:
        assert "Eval: loss" in log and "mIoU" in log and "nan" not in log.split("Train: 0")[1]
        rows = summary(work / "summary.csv")
        assert 0.0 <= rows[0]["eval_miou"] <= 1.0
        assert os.path.exists(work / "last.ckpt.npz")
    else:
        assert "Forward time (batch 2): median" in log
    x = nchw(np.random.RandomState(0).randn(1, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        y = model.eval()(x)
    assert y.shape == (1, 7, 4, 4) and torch.isfinite(y).all()


# -- prune_trunks ---------------------------------------------------------------
PRUNE_SEG = dict(num_classes=19, num_channels=(16, 32, 64, 96), num_blocks=(1, 1, 2, 1),
                 ham_channels=64, ham_rank=16, ham_iters=2)


def test_prune_trunks_on_segnext_matches_jax():
    """The JAX ``test_prune_trunks.py::test_segnext_trunk_concat_consumer`` case:
    each tapped stage's group slices its segment of the squeeze conv's input."""
    model = tiny_dense(**PRUNE_SEG)
    jmodel = jseg.SegNeXt(**dict(TINY, **PRUNE_SEG))
    jv = to_jax(model)
    assert model.decode_head.squeeze.in_channels == 32 + 64 + 96
    assert jdeploy.prune_trunks(jmodel, jv, keep_ratio=0.5, round_to=None) == 4
    assert deploy.prune_trunks(model, keep_ratio=0.5, round_to=None) == 4
    assert model.decode_head.squeeze.in_channels == jmodel.decode_head.squeeze.in_channels == 96
    assert [m.normalized_shape[0] for m in (layer[2] for layer in model.backbone.layers)] == \
        [8, 16, 32, 48]
    got = params_to_jax(model.state_dict())
    got.pop(NMF_KEY)
    want = {k: np.asarray(v) for k, v in flatten_tree(jv).items()}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    x = np.random.RandomState(7).randn(1, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        y = model(nchw(x))
    assert y.shape == (1, 19, 8, 8)
    assert rel(nhwc(y), jax_logits(jmodel, jv, x)) < LOGITS_RTOL


def test_jax_checkpoint_without_the_draw_keeps_the_ports():
    from convnet_approximater_tpu_torch import convert

    model = seg.SegNeXt(**TINY)
    flat = params_to_jax(tiny_dense().state_dict())
    del flat[NMF_KEY]
    with mock.patch.object(convert, "get_logger") as logger:
        convert.load_jax_flat(model, flat)
    assert "nmf_init" in str(logger.return_value.warning.call_args_list)
    assert torch.equal(model.decode_head.hamburger.nmf_init, seg.nmf_draw(16, 4))
    with mock.patch.dict(flat, {NMF_KEY: jax_draw(16, 4)}):
        convert.load_jax_flat(model, flat)
    np.testing.assert_array_equal(model.decode_head.hamburger.nmf_init.numpy(), jax_draw(16, 4))
