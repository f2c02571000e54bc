"""bf16 serving in the port against the JAX package, on the CPU at small sizes.

* ``cast_floating`` and ``serving_dtype`` against the JAX functions: the
  parameters cast, the buffers (running statistics) kept, and an int8
  surface (``quantize_int8`` after the cast) reading bf16 beside its float32
  scales in both packages.
* The norm layers on bf16 maps: float32 statistics, a bf16 result within one
  bf16 ulp of JAX's (both normalise in float32 and round once).
* Tiny MSCAN d1+fix and dconv0 surfaces and a tiny int8 ConvNeXt: the port's
  bf16 logits against JAX's bf16 logits (``cast_floating`` on both sides, the
  same solved weights) to the reference's own bf16 gate, relative norm 1e-2.
* The kernel routes in bf16: under ``torch.no_grad()`` in eval mode a bf16
  ``MSCA``, ``ParallelConv``, ``LowRankExpConvV1``, ``QuantConv2d`` and
  ``QuantLinear`` call their ops with bf16 x and return bf16.
* ``InferenceTimeHook(bf16=True)`` times a bf16 input on the model as it is,
  as the JAX hook does: a float32 model raises the type error JAX raises, a
  cast model is timed.
* A bf16 ``export_serving``/``load_serving`` round trip: bf16 avals, the
  live model's bits on the CPU.

``ValidateHelper(amp=True)`` is held against the JAX helper in
``tests/test_torch_finetune.py``, the bf16 ``ClassInference`` reports in
``tests/test_torch_deploy_mode.py`` and the planner's bf16 default in
``tests/test_torch_deploy_planner.py``.
"""

import copy
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import convnet_approximater_tpu.nn as jnn  # noqa: E402
from convnet_approximater_tpu.classification.validate import \
    serving_dtype as jserving_dtype  # noqa: E402
from convnet_approximater_tpu.core import MscaRep as JMscaRep  # noqa: E402
from convnet_approximater_tpu.deploy import quantize_int8 as jquantize_int8  # noqa: E402
from convnet_approximater_tpu.models import ConvNeXt as JConvNeXt  # noqa: E402
from convnet_approximater_tpu.models import MSCAN_Classifier as JClassifier  # noqa: E402
from convnet_approximater_tpu.utils import cast_floating as jcast_floating  # noqa: E402
from convnet_approximater_tpu.utils.serialize import (flatten_tree, tree_get,  # noqa: E402
                                                      unflatten_tree)
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_to_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import LowRankExpV1, MscaRep  # noqa: E402
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.hooks import InferenceTimeHook  # noqa: E402
from convnet_approximater_tpu_torch.layers import MSCA, ParallelConv  # noqa: E402
from convnet_approximater_tpu_torch.models import ConvNeXt, MSCAN_Classifier  # noqa: E402
from convnet_approximater_tpu_torch.nn import (BatchNorm2d, Conv2d, GroupNorm,  # noqa: E402
                                               LayerNorm, channels_last, init_weights)
from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops  # noqa: E402
from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops  # noqa: E402
from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops  # noqa: E402
from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops  # noqa: E402
from convnet_approximater_tpu_torch.utils.dtype import cast_floating, serving_dtype  # noqa: E402

torch.set_num_threads(1)
BF16_REL_TOL = 1e-2  # scripts/plan_serving.py's bf16 gate: relative Frobenius norm
BF16_ULP = 2.0 ** -7
TINY = dict(num_channels=(8, 16), num_blocks=(1, 1), exp_ratios=(2, 2), num_classes=10)
CONVNEXT = dict(num_classes=10, depths=(1, 1, 1, 1), dims=(8, 16, 16, 24), layer_scale=1.0)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def images(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def nchw(x, dtype=torch.float32):
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)


def port_logits(model, x, dtype=torch.bfloat16):
    with torch.no_grad():
        return model.eval()(nchw(x, dtype)).float().numpy()


def jax_logits(jmodel, variables, x, dtype=jnp.bfloat16):
    y = jmodel.apply(variables["params"], jnp.asarray(x).astype(dtype),
                     state=variables.get("state", {}), training=False)[0]
    return np.asarray(y.astype(jnp.float32))


def jvars_of(model):
    v = unflatten_tree({k: jnp.asarray(a) for k, a in params_to_jax(model.state_dict()).items()})
    v.setdefault("state", {})
    return v


def randomized_mscan():
    """A tiny MSCAN with layer scales 1 and BN statistics of order 1."""
    model = MSCAN_Classifier(**TINY)
    init_weights(model, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if "layer_scale" in name:
                t.fill_(1.0)
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy((0.3 * rs.randn(*t.shape)).astype(np.float32)))
    return channels_last(model).eval()


# -- cast_floating and serving_dtype --------------------------------------------
@pytest.fixture(scope="module")
def convnext_int8():
    """A tiny ConvNeXt in both packages from the same weights: the parameter
    dtypes after ``cast_floating``, then the int8 surface quantized after the
    cast on the same bf16 calibration batch (one JAX model for the module)."""
    model = ConvNeXt(**CONVNEXT)
    init_weights(model, torch.Generator().manual_seed(7))
    model = channels_last(model).eval()
    jmodel, jv = JConvNeXt(**CONVNEXT), jvars_of(model)
    cast_floating(model)
    jv = {"params": jcast_floating(jv["params"]), "state": jv["state"]}
    cast = dict(dtypes={k: v.dtype for k, v in model.state_dict().items()},
                jdtypes={f"params/{k}": v.dtype for k, v in flatten_tree(jv["params"]).items()},
                serving=(serving_dtype(model), jserving_dtype(jv["params"])))
    calib = images((4, 32, 32, 3), 8)
    n = deploy.quantize_int8(model, [nchw(calib, torch.bfloat16)])
    jn = jquantize_int8(jmodel, jv, [jnp.asarray(calib).astype(jnp.bfloat16)])
    return dict(cast, model=model, jmodel=jmodel, jv=jv, n=(n, jn))


def test_cast_floating_and_serving_dtype_match_jax(convnext_int8):
    r = convnext_int8
    assert all(d == torch.bfloat16 for k, d in r["dtypes"].items()
               if not k.endswith(("running_mean", "running_var")))
    assert all(v == jnp.bfloat16 for v in r["jdtypes"].values())
    assert len(r["jdtypes"]) == sum(not k.endswith(("running_mean", "running_var"))
                                    for k in r["dtypes"])
    assert r["serving"] == (torch.bfloat16, jnp.bfloat16)
    # the int8 surface: bf16 weights beside float32 scales, read as bf16 in both
    model, jv = r["model"], r["jv"]
    assert r["n"][0] == r["n"][1] > 0
    scales = {k: v for k, v in flatten_tree(jv["params"]).items()
              if k.endswith(("w_scale", "act_scale"))}
    assert scales and all(v.dtype == jnp.float32 for v in scales.values())
    assert serving_dtype(model) == torch.bfloat16 and jserving_dtype(jv["params"]) == jnp.bfloat16
    for _ in range(2):  # a second cast leaves the int8 modules' float32 scales
        assert all(p.dtype == torch.float32 for k, p in model.named_parameters()
                   if k.endswith(("w_scale", "act_scale")))
        cast_floating(model)


# -- the norms ----------------------------------------------------------------------
NORMS = {"BatchNorm2d": (lambda: BatchNorm2d(8), lambda: jnn.BatchNorm2d(8)),
         "LayerNorm": (lambda: LayerNorm(8), lambda: jnn.LayerNorm(8)),
         "GroupNorm": (lambda: GroupNorm(2, 8), lambda: jnn.GroupNorm(2, 8))}


@pytest.mark.parametrize("name", sorted(NORMS))
def test_norms_normalise_bf16_in_float32_as_jax(name):
    make, jmake = NORMS[name]
    norm = make()
    rs = np.random.RandomState(4)
    with torch.no_grad():
        for k, t in norm.state_dict().items():
            t.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, t.shape).astype(np.float32)))
    jv = jvars_of(norm)
    cast_floating(norm)
    assert all(b.dtype == torch.float32 for b in norm.buffers())
    x = images((2, 5, 6, 8), 5) * 3 + 1
    with torch.no_grad():
        y = norm.eval()(nchw(x, torch.bfloat16))
    assert y.dtype == torch.bfloat16
    y_j = jmake().apply(jcast_floating(jv["params"]), jnp.asarray(x).astype(jnp.bfloat16),
                        state=jv["state"], training=False)[0]
    assert y_j.dtype == jnp.bfloat16
    got, want = y.float().permute(0, 2, 3, 1).numpy(), np.asarray(y_j.astype(jnp.float32))
    assert (np.abs(got - want) <= np.maximum(np.abs(got), np.abs(want)) * BF16_ULP).all()


def test_float64_batchnorm_keeps_its_affine_parameters():
    """A float64 BatchNorm (the float64 arbiter of the CAM methods) normalises
    with its own float64 scale and shift, as ``F.batch_norm`` does given them."""
    norm = BatchNorm2d(8).double().eval()
    rs = np.random.RandomState(12)
    with torch.no_grad():
        for t in norm.state_dict().values():
            t.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, t.shape)))
    x = torch.from_numpy(rs.randn(2, 8, 5, 6) * 3 + 1)
    with torch.no_grad():
        y = norm(x)
        want = torch.nn.functional.batch_norm(x, norm.running_mean, norm.running_var,
                                              norm.weight, norm.bias, False, 0.1, norm.eps)
    assert y.dtype == torch.float64
    torch.testing.assert_close(y, want, rtol=0, atol=0)


# -- the logits against JAX bf16 -------------------------------------------------
def jax_forward(jmodel, jv, x):
    """JAX's bf16 logits, one compiled forward."""
    f = jax.jit(lambda p, s, x: jmodel.apply(p, x, state=s, training=False)[0])
    return np.asarray(f(jv["params"], jv["state"], jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32))


def zeros(key, shape=(), dtype=jnp.float32, *args, **kwargs):
    return np.zeros(shape, np.float32)


@pytest.mark.parametrize("decomp_conv0", [False, True], ids=["d1+fix", "dconv0"])
def test_mscan_surfaces_in_bf16_match_jax_bf16(decomp_conv0):
    """MscaRep d1+fix (dconv0: conv0 a cascade too) solved in the port, its 1x1
    convs as matmuls, then cast; JAX's surface of the same structure (its app in
    deploy mode builds the bare targets; their random draws, overwritten at once,
    are skipped) holds the same weights, cast by JAX's ``cast_floating``."""
    model = randomized_mscan()
    assert apply_app(model, MscaRep(decomp=1, fix=True, decomp_conv0=decomp_conv0)) == 2
    deploy.enable_pw_matmul(model)
    jmodel = JClassifier(**TINY)
    japp = JMscaRep(decomp=1, fix=True, decomp_conv0=decomp_conv0, deploy=True)
    jmodel.register_switchable(japp.src_type, [])
    jv = jvars_of(randomized_mscan())
    with mock.patch("jax.random.uniform", zeros), mock.patch("jax.random.normal", zeros):
        for idx, name in enumerate(jmodel.switchable_names):
            tgt, tparams = japp.initialize(jmodel.get_switchable_module(idx),
                                           tree_get(jv["params"], name), jax.random.key(0))
            jmodel.set_switchable_module(idx, tgt, jv, {"params": tparams})
    jv = jvars_of(model)
    x = images((2, 32, 32, 3), 6)
    y32 = port_logits(model, x, torch.float32)
    cast_floating(model)
    with torch.no_grad():
        fused = [m.can_fuse() for m in model.modules() if isinstance(m, MSCA)]
    assert fused == [not decomp_conv0] * 2
    y = port_logits(model, x)
    y_j = jax_forward(jmodel, {"params": jcast_floating(jv["params"]), "state": jv["state"]}, x)
    assert rel(y, y_j) <= BF16_REL_TOL
    assert rel(y, y32) <= BF16_REL_TOL and np.abs(y32).max() > 1e-2


def qmatmul_f64(x, w_packed, a_scale, w_scale, bias=None):
    """qmatmul in float64: x quantized by the same act scale, the exact integer
    sum, the dequant and the bias, all in float64."""
    q = torch.clamp(torch.round(x / a_scale), -qmatmul_ops.INT8_MAX, qmatmul_ops.INT8_MAX)
    y = (q @ w_packed[:, :x.shape[1]].double().t()) * (a_scale * w_scale)
    return y + bias if bias is not None else y


def test_int8_convnext_in_bf16_matches_jax_bf16(convnext_int8):
    """The int8 logits in bf16.  Each package calibrates its own act scales on
    its own bf16 forward, so a scale may differ by a bf16 rounding and move a
    quantized value: the gate is the reference's 1e-2 relative norm, or, where
    that misses, the port's bf16 logits no further from a float64 forward than
    twice JAX's.  The float64 forward is the port's int8 model with its bf16
    weights, float32 scales and biases upcast to float64 (exactly), the same
    act scales, and every layer in float64.  Measured on the CPU: the two bf16
    logits 0.0142 apart; from the float64 forward the port's 0.0148, JAX's 0.0151."""
    model, jmodel, jv = convnext_int8["model"], convnext_int8["jmodel"], convnext_int8["jv"]
    x = images((2, 32, 32, 3), 9)
    y, y_j = port_logits(model, x), jax_forward(jmodel, jv, x)
    with mock.patch.object(qmatmul_ops, "qmatmul", qmatmul_f64):
        y64 = port_logits(copy.deepcopy(model).double(), x, torch.float64)
    assert rel(y, y_j) <= BF16_REL_TOL or rel(y, y64) <= 2 * rel(y_j, y64)


# -- the kernel routes in bf16 -------------------------------------------------------
@pytest.fixture
def calls(monkeypatch):
    seen = []

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(x, *args, **kwargs):
            y = real(x, *args, **kwargs)
            seen.append((name, x.dtype, y.dtype))
            return y

        monkeypatch.setattr(module, name, wrapped)

    for module, name in ((fused_ops, "msca_fused"), (cascade_ops, "parallel_cascade"),
                         (lowrank_ops, "lowrank_conv"), (qmatmul_ops, "qmatmul")):
        spy(module, name)
    return seen


def test_bf16_layers_take_their_kernels_in_eval_without_autograd(calls):
    g = torch.Generator().manual_seed(11)
    msca = MSCA(8, 5, (7, 11, 21))
    init_weights(msca, g)
    bank = ParallelConv(8, [7, 11], [3, 5], 2, all_bias=True, identity=True)
    init_weights(bank, g)
    conv = Conv2d(8, 6, 3, padding=1)
    init_weights(conv, g)
    low = LowRankExpV1(num_bases=(3,), do_decomp=True, max_iter=0, min_lmda=0, max_lmda=0,
                       lmda_length=1)
    sub = low.initialize(conv, g)
    low.optimize(sub)
    lowrank = low.postprocess(sub)
    lin = torch.nn.Linear(8, 5)
    init_weights(lin, g)
    seq = torch.nn.Sequential(lin)
    deploy.quantize_int8(seq, [torch.randn(4, 8, generator=g)])
    qconv = torch.nn.Sequential(Conv2d(8, 4, 3, padding=1))
    init_weights(qconv, g)
    deploy.quantize_int8(qconv, [torch.randn(2, 8, 9, 9, generator=g)])
    x = torch.randn(2, 8, 9, 9, generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        for m, inp in ((msca, x), (bank, x), (lowrank, x), (qconv, x),
                       (seq, torch.randn(3, 8, generator=g).to(torch.bfloat16))):
            channels_last(cast_floating(m)).eval()
            assert m(inp).dtype == torch.bfloat16
    assert calls == [(n, torch.bfloat16, torch.bfloat16) for n in
                     ("msca_fused", "parallel_cascade", "lowrank_conv", "qmatmul", "qmatmul")]
    calls.clear()
    assert msca(x).dtype == torch.bfloat16 and calls == []  # autograd on: the module path


# -- the timer and the export ----------------------------------------------------------
def test_bf16_hook_times_the_model_as_it_is_like_jax():
    model = randomized_mscan()
    runner = SimpleNamespace(model=model, device=torch.device("cpu"))
    hook = InferenceTimeHook(runner, 50, infer_cfg=dict(input_size=(1, 16, 16, 3), bf16=True,
                                                        num_iters=1, warmup=1))
    with pytest.raises(RuntimeError, match="BFloat16|bfloat16|same"):
        hook.after_run()  # a float32 model under a bf16 input, as JAX's TypeError
    jmodel = JClassifier(**TINY)
    jv = jvars_of(model)
    with pytest.raises(TypeError, match="same dtypes"):
        jax_logits(jmodel, jv, images((1, 16, 16, 3), 0))
    cast_floating(model)
    hook.after_run()
    assert hook.result["dtype"] == torch.bfloat16 and hook.result["median_ms"] > 0


def test_bf16_export_round_trip_is_bit_equal_on_the_cpu(tmp_path):
    model = randomized_mscan()
    apply_app(model, MscaRep(decomp=1, fix=True))
    cast_floating(model)
    x = nchw(images((2, 32, 32, 3), 12), torch.bfloat16)
    deploy.export_serving(model, (x,), path=str(tmp_path / "m.pt2"))
    loaded = deploy.load_serving(str(tmp_path / "m.pt2"))
    assert loaded.in_avals[0].dtype == loaded.out_avals[0].dtype == torch.bfloat16
    assert deploy.custom_op_counts(loaded) == {"msca_fused": 2}
    with torch.no_grad():
        assert torch.equal(loaded(x), model(x))
