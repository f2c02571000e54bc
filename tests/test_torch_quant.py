"""The port's int8 post-training quantization against the JAX package.

* the weight and activation quantizers, bit for bit, exact .5 ties included
  (both round half to even);
* ``qmatmul_ref`` (what the wrapper runs on CPU tensors, and what the CUDA
  kernel is checked against on the card) and ``QuantLinear`` against the JAX
  ``QuantLinear``, which computes the same function as the Pallas probe's
  ``xla_qmatmul``; ``QuantConv2d`` in the patchify (4x4/4) and the padded 3x3
  forms against the JAX ``QuantConv2d``: 1e-6 relative (the integer sums are
  exact, the float32 epilogue is the same three roundings);
* ``deploy.quantize_int8`` on a tiny ConvNeXt after DwSepRep: 15 modules,
  the calibrated ``act_scale``s within 1e-6 of JAX's, the int8 logits within
  1e-4 of the JAX int8 model's.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu.core import DwSepRep as JDwSepRep  # noqa: E402
from convnet_approximater_tpu.deploy import quantize_int8 as jquantize_int8  # noqa: E402
from convnet_approximater_tpu.filters import DepthwiseConvFilter as JDepthwiseConvFilter  # noqa: E402
from convnet_approximater_tpu.layers import quant as jquant  # noqa: E402
from convnet_approximater_tpu.models import ConvNeXt as JConvNeXt  # noqa: E402
from convnet_approximater_tpu.nn import Conv2d as JConv2d  # noqa: E402
from convnet_approximater_tpu.nn import Linear as JLinear  # noqa: E402
from convnet_approximater_tpu.utils import serialize as jser  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import DwSepRep  # noqa: E402
from convnet_approximater_tpu_torch.filters import DepthwiseConvFilter  # noqa: E402
from convnet_approximater_tpu_torch.hooks import count_macs  # noqa: E402
from convnet_approximater_tpu_torch.layers import QuantConv2d, QuantLinear, quant  # noqa: E402
from convnet_approximater_tpu_torch.models import ConvNeXt  # noqa: E402
from convnet_approximater_tpu_torch.nn import Conv2d, Linear  # noqa: E402
from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-6
TINY = dict(depths=(1, 1, 2, 1), dims=(16, 24, 32, 48), num_classes=10, layer_scale=1.0)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def jax_apply(module, params, x):
    """The JAX model's output, jitted (one compile instead of one per op)."""
    return np.asarray(jax.jit(lambda p, x: module.apply(p, x)[0])(params, jnp.asarray(x)))


def load(tmod, params):
    tmod.load_state_dict(params_from_jax(jser.flatten_tree({"params": params})))
    return tmod.eval()


def test_weight_quantizers_match_jax_bit_for_bit():
    rs = np.random.RandomState(0)
    w = rs.randn(3, 3, 5, 6).astype(np.float32)  # HWIO
    # out channel 0: absmax 127, scale 1.0, so its values land on .5 ties exactly
    w[..., 0] = rs.randint(-126, 126, (3, 3, 5)) + 0.5
    w[0, 0, 0, 0] = 127.0
    wq_j, s_j = jquant.quantize_weight_per_channel(jnp.asarray(w))
    wq, s = quant.quantize_weight_per_channel(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    assert float(s_j[0]) == 1.0
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    ties = wq.numpy()[0].ravel()[1:]  # all but the 127 at (in 0, 0, 0)
    assert set(np.abs(ties) % 2) == {0}  # ties went to the even neighbour

    lw = rs.randn(7, 4).astype(np.float32)  # (in, out)
    lw[:, 1] = [0.5, -1.5, 2.5, 127.0, -3.5, 64.5, -0.5]
    lq_j, ls_j = jquant.quantize_linear_weight(jnp.asarray(lw))
    lq, ls = quant.quantize_linear_weight(torch.from_numpy(lw.T.copy()))
    np.testing.assert_array_equal(lq.numpy(), np.asarray(lq_j).T)
    np.testing.assert_array_equal(ls.numpy(), np.asarray(ls_j))
    np.testing.assert_array_equal(lq.numpy()[1], [0, -2, 2, 127, -4, 64, 0])


def test_activation_quantizer_matches_jax_bit_for_bit():
    x = np.concatenate([np.arange(-70, 70, dtype=np.float32) * 0.25 + 0.125,  # ties at /0.25
                        np.random.RandomState(1).randn(200).astype(np.float32) * 40])
    for scale in (0.25, 0.0917, 1e-3):
        q_j = jquant.quantize_activation(jnp.asarray(x), jnp.float32(scale))
        q = quant.quantize_activation(torch.from_numpy(x), torch.tensor(scale))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    q = quant.quantize_activation(torch.tensor([0.375, 0.625, -0.125, 1e9]), torch.tensor(0.25))
    assert q.tolist() == [2, 2, 0, 127]


def _jax_linear(K, N, seed, bias=True):
    lin = JLinear(K, N, bias=bias)
    params = lin.init(jax.random.key(seed))
    return lin, params


@pytest.mark.parametrize("K,N,bias", [(48, 24, True), (96, 40, True), (37, 10, False)])
def test_qmatmul_ref_and_quant_linear_match_jax(K, N, bias):
    lin, params = _jax_linear(K, N, seed=K, bias=bias)
    x = np.random.RandomState(K).randn(5, 3, K).astype(np.float32)
    act_scale = float(np.abs(x).max()) / 127.0
    jq, jp = jquant.QuantLinear.from_linear(lin, params, act_scale)
    y_j = np.asarray(jq.apply(jp, jnp.asarray(x))[0])

    tq = QuantLinear.from_linear(load(Linear(K, N, bias=bias), params), act_scale)
    # the converted JAX int8 params load into the port's module unchanged
    np.testing.assert_array_equal(tq.weight_q.numpy(), np.asarray(jp["weight_q"]).T)
    other = load(QuantLinear(K, N, bias=bias), jp)
    for name, t in tq.state_dict().items():
        torch.testing.assert_close(other.state_dict()[name], t, rtol=0, atol=0)
    with torch.no_grad():
        y = tq(torch.from_numpy(x))
    assert y.shape == (5, 3, N)
    assert rel(y.numpy(), y_j) < RTOL
    w = qmatmul_ops.pack_qweight(tq.weight_q)
    assert w.shape == (N, -(-K // 32) * 32) and not w[:, K:].any()
    y_ref = qmatmul_ops.qmatmul_ref(torch.from_numpy(x.reshape(-1, K)), w, tq.act_scale,
                                    tq.w_scale, tq.bias)
    assert rel(y_ref.numpy(), y_j.reshape(-1, N)) < RTOL
    assert tq.macs((5, 3, K)) == 15 * K * N


@pytest.mark.parametrize("cin,cout,k,stride,pad,hw", [(3, 16, 4, 4, 0, 16), (8, 12, 2, 2, 0, 9),
                                                      (6, 10, 3, 1, 1, 7), (5, 4, 3, 2, 1, 9)],
                         ids=["stem-4x4/4", "downsample-2x2/2", "padded-3x3", "padded-3x3/2"])
def test_quant_conv2d_matches_jax(cin, cout, k, stride, pad, hw):
    conv = JConv2d(cin, cout, k, stride=stride, padding=pad)
    params = conv.init(jax.random.key(cin))
    x = np.random.RandomState(cin).randn(2, hw, hw, cin).astype(np.float32)
    act_scale = float(np.abs(x).max()) / 127.0
    jq, jp = jquant.QuantConv2d.from_conv(conv, params, act_scale)
    y_j = np.asarray(jq.apply(jp, jnp.asarray(x))[0])

    tq = QuantConv2d.from_conv(load(Conv2d(cin, cout, k, stride=stride, padding=pad), params),
                               act_scale)
    assert tq.patchify == (stride == k and pad == 0)
    np.testing.assert_array_equal(tq.weight_q.numpy(),
                                  np.asarray(jp["weight_q"]).transpose(3, 2, 0, 1))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = tq(xt)
    assert y.shape == (2, cout) + y_j.shape[1:3]
    assert rel(y.permute(0, 2, 3, 1).numpy(), y_j) < RTOL
    assert tq.macs(tuple(xt.shape)) == y.numel() * cin * k * k


def test_quant_modules_are_inference_only():
    tq = QuantLinear.from_linear(Linear(8, 4), 0.01)
    tc = QuantConv2d.from_conv(Conv2d(3, 4, 2, stride=2), 0.01)
    tq.train()
    tc.train()
    with pytest.raises(RuntimeError, match="inference-only"):
        tq(torch.zeros(2, 8))
    with pytest.raises(RuntimeError, match="inference-only"):
        tc(torch.zeros(1, 3, 4, 4))
    with pytest.raises(ValueError, match="dense"):
        QuantConv2d.from_conv(Conv2d(4, 4, 3, groups=4), 0.01)


def test_packed_weight_is_cached_per_version():
    tq = QuantLinear.from_linear(Linear(40, 6), 0.02).eval()
    p = tq.packed()
    assert tq.packed() is p
    with torch.no_grad():
        tq.weight_q[0, 0] = 5
    assert tq.packed() is not p and int(tq.packed()[0, 0]) == 5


def test_qmatmul_checks_its_arguments():
    x = torch.randn(4, 40)
    w = qmatmul_ops.pack_qweight(torch.ones(6, 40, dtype=torch.int8))
    a, s, b = torch.tensor(0.1), torch.ones(6), torch.zeros(6)
    assert qmatmul_ops.qmatmul(x, w, a, s, b).shape == (4, 6)
    with pytest.raises(ValueError, match="pack_qweight"):
        qmatmul_ops.qmatmul(x, torch.ones(6, 40, dtype=torch.int8), a, s, b)
    with pytest.raises(TypeError, match="float32"):
        qmatmul_ops.qmatmul(x.double(), w, a, s, b)
    with pytest.raises(ValueError, match="a_scale"):
        qmatmul_ops.qmatmul(x, w, a.reshape(1), s, b)
    with pytest.raises(ValueError, match="contiguous"):
        qmatmul_ops.qmatmul(torch.randn(40, 4).t(), w, a, s, b)



# the (M, K, N) of int8 ConvNeXt-T's 13 qmatmul calls at b=64, 224^2, and ragged shapes
QMM_PLAN_SHAPES = [(200704, 48, 96), (50176, 384, 192), (12544, 768, 384), (3136, 1536, 768),
                   (200704, 96, 384), (50176, 192, 768), (12544, 384, 1536), (3136, 768, 3072),
                   (200704, 384, 96), (50176, 768, 192), (12544, 1536, 384), (3136, 3072, 768),
                   (64, 768, 1000), (1000, 100, 250), (130, 33, 7), (4097, 776, 130)]


@pytest.mark.parametrize("M,K,N", QMM_PLAN_SHAPES)
def test_qmatmul_plan_fits_shared_memory_and_fills_the_card(M, K, N):
    """The kernel's plan: within 227 KB of shared memory, every column covered,
    a whole panel wherever a block walks several column tiles, and a grid of at
    least 132 blocks wherever the row tiles times N over the narrowest column
    tile (16 at BM = 64: two warpgroups of 8) allow it."""
    p = qmatmul_ops.plan(M, K, N)
    Kp = qmatmul_ops.pack_qweight(torch.zeros(1, K, dtype=torch.int8)).shape[1]
    assert p.smem == qmatmul_ops.smem_bytes(p.bm, p.bn, p.ra, p.sx, p.sb) <= 232_448
    assert p.kc == -(-Kp // qmatmul_ops.CHUNK)
    assert p.bn == (p.bnw if p.bm == 128 else 2 * p.bnw) and p.bnw in qmatmul_ops.BNWS[p.bm]
    assert p.m_tiles * p.bm >= M > (p.m_tiles - 1) * p.bm
    assert p.n_tiles * p.bn >= N and p.groups * p.ntpb >= p.n_tiles > (p.groups - 1) * p.ntpb
    assert p.ra == p.kc if p.ntpb > 1 else 2 <= p.ra <= p.kc or p.ra == p.kc == 1
    assert min(p.sx, p.sb) >= 2
    assert p.grid >= min(qmatmul_ops.SMS, p.m_tiles * -(-N // 16))


def test_pack_qweight_pads_k_to_the_kernel_step():
    """K is zero-padded to K_ALIGN (one wgmma k32 step), and the wrapper takes
    only a weight packed for its K."""
    assert qmatmul_ops.K_ALIGN == 32
    w_q = torch.randint(-127, 128, (7, 33), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int8)
    w = qmatmul_ops.pack_qweight(w_q)
    assert w.shape == (7, 64) and torch.equal(w[:, :33], w_q) and not w[:, 33:].any()
    x, a, s = torch.randn(5, 33), torch.tensor(0.05), torch.rand(7)
    assert torch.equal(qmatmul_ops.qmatmul(x, w, a, s), qmatmul_ops.qmatmul_ref(x, w, a, s))
    with pytest.raises(ValueError, match="pack_qweight"):
        qmatmul_ops.qmatmul(x, torch.nn.functional.pad(w, (0, 32)), a, s)


# -- quantize_int8 on a tiny DwSepRep ConvNeXt ----------------------------------

@pytest.fixture(scope="module")
def int8_pair():
    """The same DwSepRep ConvNeXt in both packages (the port's holds JAX's
    solved weights), quantized by each package's quantize_int8 on the same two
    calibration batches; and the port's float model before quantization."""
    jmodel = JConvNeXt(**TINY)
    variables = {"params": jax.jit(jmodel.init)(jax.random.key(0))}
    app = JDwSepRep(ranks=1)
    jmodel.register_switchable(app.src_type, [JDepthwiseConvFilter()])
    for idx, name in enumerate(jmodel.switchable_names):
        sub, sp = app.initialize(jmodel.get_switchable_module(idx),
                                 jser.tree_get(variables["params"], name))
        app.optimize(sub, sp)
        module, new = app.postprocess(sub, sp)
        jmodel.set_switchable_module(idx, module, variables, {"params": new})

    model = ConvNeXt(**TINY)
    tapp = DwSepRep(ranks=1)
    model.register_switchable(tapp.src_type, [DepthwiseConvFilter()])
    for idx in range(model.length_switchable):
        model.set_switchable_module(idx, tapp.postprocess(
            tapp.initialize(model.get_switchable_module(idx))))
    model.load_state_dict(params_from_jax(jser.flatten_tree(variables)))  # strict
    model = model.to(memory_format=torch.channels_last).eval()

    rs = np.random.RandomState(7)
    calib = [rs.randn(2, 64, 64, 3).astype(np.float32) for _ in range(2)]
    x = rs.randn(2, 64, 64, 3).astype(np.float32)
    y_f = torch_logits(model, x)
    n_j = jquantize_int8(jmodel, variables, [jnp.asarray(c) for c in calib])
    n = deploy.quantize_int8(model, [to_torch(c) for c in calib])
    return dict(jmodel=jmodel, variables=variables, model=model, n_j=n_j, n=n, x=x, y_f=y_f)


def to_torch(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def torch_logits(model, x):
    with torch.no_grad():
        return model(to_torch(x)).numpy()


def test_quantize_int8_counts_and_scales_match_jax(int8_pair):
    model, jparams = int8_pair["model"], int8_pair["variables"]["params"]
    assert int8_pair["n"] == int8_pair["n_j"] == 15  # stem + 3 downsamples + 5 x 2 pwconvs + head
    quantized = {p: m for p, m in model.named_modules() if isinstance(m, (QuantConv2d, QuantLinear))}
    assert len(quantized) == 15
    assert isinstance(quantized["downsample_layers.0.0"], QuantConv2d)
    assert isinstance(quantized["stages.2.1.pwconv2"], QuantLinear)
    for path, m in quantized.items():
        want = float(jser.tree_get(jparams, path + ".act_scale"))
        assert abs(float(m.act_scale) - want) <= 1e-6 * want, path
        np.testing.assert_array_equal(
            m.w_scale.numpy(), np.asarray(jser.tree_get(jparams, path + ".w_scale")))
    # the strip cascades are depthwise and stay float
    assert not any(isinstance(m, (QuantConv2d, QuantLinear))
                   for p, m in model.named_modules() if "dwconv" in p)


def test_quantize_int8_logits_match_jax(int8_pair):
    y_j = jax_apply(int8_pair["jmodel"], int8_pair["variables"]["params"], int8_pair["x"])
    y = torch_logits(int8_pair["model"], int8_pair["x"])
    assert rel(y, y_j) < 1e-4
    # int8 is another function than float32, close to it
    y_f = int8_pair["y_f"]
    assert 1e-4 < float(np.abs(y - y_f).max() / np.abs(y_f).max()) < 0.12


def test_quantized_model_counts_its_macs(int8_pair):
    model = int8_pair["model"]
    x = torch.zeros(1, 3, 64, 64).contiguous(memory_format=torch.channels_last)
    dense = ConvNeXt(**TINY).eval()  # float, with the 7x7 dwconvs
    assert count_macs(model, x) == count_macs(dense, x) - _dw_macs_saved(x)


def _dw_macs_saved(x):
    """MACs the five rank-1 cascades save over the dense 7x7 dwconvs at ``x``'s size."""
    H = x.shape[2] // 4
    total = 0
    for s, (d, c) in enumerate(zip(TINY["depths"], TINY["dims"])):
        h = H >> s
        total += d * c * h * h * (49 - 14)
    return total


def test_quantize_int8_filter_and_empty_calibration():
    model = ConvNeXt(depths=(1, 1, 1, 1), dims=(8, 8, 8, 8), num_classes=4).eval()
    n = deploy.quantize_int8(model, [torch.randn(1, 3, 32, 32)],
                             filter_fn=lambda path, m: path.startswith("stages.1"))
    assert n == 2 and isinstance(model.stages[1][0].pwconv1, QuantLinear)
    assert type(model.head) is Linear
    assert deploy.quantize_int8(model, [torch.randn(1, 3, 32, 32)], linears=False) == 4
    with pytest.raises(ValueError, match="calibration batch"):
        deploy.quantize_int8(ConvNeXt(depths=(1, 1, 1, 1), dims=(8, 8, 8, 8), num_classes=4), [])
