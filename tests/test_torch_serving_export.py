"""The serving export of the port: the kernels as ``torch.library`` custom ops,
``export_serving``/``load_serving`` through ``torch.export``, and the batch
wrappers, against the JAX package where it has a counterpart.

* ``torch.library.opcheck`` passes for each of the four ops on the CPU (where
  the op is the kernel's plain version).
* An exported model that holds each kernel layer (MSCA d1+fix, the dense-bank
  MSCA, ``ParallelConv``, ``LowRankExpConvV1`` with shared bases,
  ``QuantConv2d``) loads from bytes and from a path and gives the live
  forward's logits (1e-6 relative), with one op node per kernel call and the
  kernels' weights read from the program's parameters and constants, never
  computed per call; exported with a symbolic batch it serves b = 1, 3, 5.
* A tiny MSCAN exported in both packages from the same weights: the port's
  artifact within 1e-5 of the JAX artifact on the CPU.
* ``pad_batch``, ``pad_batch_to_multiple`` and ``chunk_batch`` against the
  JAX wrappers on the same numpy inputs (``tests/test_deploy.py``'s cases),
  and their ``ValueError``s for an output leaf that is not batch-major.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu import deploy as jdeploy  # noqa: E402
from convnet_approximater_tpu.models import MSCAN_Classifier as JClassifier  # noqa: E402
from convnet_approximater_tpu_torch import deploy  # noqa: E402
from convnet_approximater_tpu_torch.core import MscaRep  # noqa: E402
from convnet_approximater_tpu_torch.deploy_planner import apply_app  # noqa: E402
from convnet_approximater_tpu_torch.layers import (MSCA, LowRankExpConvV1,  # noqa: E402
                                                   ParallelConv, QuantConv2d)
from convnet_approximater_tpu_torch.models import MSCAN_Classifier  # noqa: E402
from convnet_approximater_tpu_torch.nn import (Conv2d, channels_last,  # noqa: E402
                                               frozen_params_keys, init_weights)
from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops  # noqa: E402
from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops  # noqa: E402
from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops  # noqa: E402
from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops  # noqa: E402
from tests.test_torch_arbitrated_apply import drawn, port_of  # noqa: E402

torch.set_num_threads(1)
LOADED_RTOL = 1e-6   # the loaded artifact against the live forward: the same ops, the same weights
JAX_RTOL = 1e-5      # the port's artifact against the JAX artifact: float32 sums in another order
TINY = dict(num_channels=(8, 12, 16, 20), num_blocks=(1, 1, 1, 1), exp_ratios=(2, 2, 2, 2),
            num_classes=10)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def nchw(x: np.ndarray) -> torch.Tensor:
    """An NHWC numpy batch as the port's input: NCHW, channels_last in memory."""
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def batch(b: int, size: int = 32, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed + b).randn(b, size, size, 3).astype(np.float32)


# -- the ops --------------------------------------------------------------
def _msca_args(gen):
    B, H, W, C, nb, k_max, fix_p = 2, 6, 7, 8, 1, 7, 3
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    return (r(B, H, W, C), r(5, 5, C), r(C), r(nb, k_max, C), r(nb, C), r(nb, k_max, C),
            r(nb, C), r(C, C), r(C), r(2, fix_p, C), [k_max], True, fix_p)


def _lowrank_args(gen, full: bool):
    B, H, W, C, M, N = 2, 7, 6, 5, 3, 4
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    A_mc, b = r(M * C, N), r(N)
    taps = dict(bases=r(M, 3, 3)) if full else dict(v=r(M, 3), h=r(M, 3))
    packed = lowrank_ops.pack_kernel_weights(A_mc, **taps)
    return (r(B, H, W, C), A_mc, b, taps.get("v"), taps.get("h"), taps.get("bases"),
            packed["w"], packed["taps"], [3, 3], [2, 1], [1, 1])


def _cascade_args(gen):
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    w1, b1, w2, b2, ks = fused_ops.pack_cascade_weights(
        [r(5, 6), r(3, 6)], [r(6), None], [r(5, 6), r(3, 6)], [r(6), r(6)])
    return r(2, 7, 5, 6), w1, b1, w2, b2, list(ks), True


def _qmatmul_args(gen):
    x = torch.randn(9, 37, generator=gen)
    w_q = torch.randint(-127, 128, (11, 37), generator=gen, dtype=torch.int8)
    return (x, qmatmul_ops.pack_qweight(w_q), torch.tensor(0.02), torch.rand(11, generator=gen),
            torch.randn(11, generator=gen))


OPS = {"msca_fused": (fused_ops.msca_fused_op, _msca_args),
       "lowrank_conv separable": (lowrank_ops.lowrank_conv_op,
                                  lambda g: _lowrank_args(g, full=False)),
       "lowrank_conv full bases": (lowrank_ops.lowrank_conv_op,
                                   lambda g: _lowrank_args(g, full=True)),
       "parallel_cascade": (cascade_ops.parallel_cascade_op, _cascade_args),
       "qmatmul": (qmatmul_ops.qmatmul_op, _qmatmul_args)}


@pytest.mark.parametrize("name", sorted(OPS))
def test_opcheck_on_the_cpu(name):
    """Schema, fake kernel (under static and dynamic shapes) and dispatch of
    each kernel's op, whose CPU implementation is the plain version."""
    op, make_args = OPS[name]
    torch.library.opcheck(op, make_args(torch.Generator().manual_seed(0)))


# -- export and load ---------------------------------------------------------
class KernelLayers(torch.nn.Module):
    """One of each kernel layer the d1+fix MSCAN does not hold, in a row."""

    def __init__(self, gen):
        super().__init__()
        self.stem = Conv2d(3, 8, 3, padding=1)
        self.lowrank = LowRankExpConvV1(8, 12, 3, 1, 1, num_base=3, decomp=True)
        self.bank = ParallelConv(12, [5, 7], [2, 3], 2, all_bias=True, identity=True)
        self.msca = MSCA(12, 5, (7, 11, 21))
        self.quant = Conv2d(12, 16, 3, padding=1)
        self.head = torch.nn.Linear(16, 10)
        init_weights(self, gen)
        with torch.no_grad():  # the same M bases in every input channel's group
            sep = self.lowrank.s_conv
            sep.v_conv.weight.copy_(torch.randn(3, 1, 3, 1, generator=gen).repeat(8, 1, 1, 1))
            sep.h_conv.weight.copy_(torch.randn(3, 1, 1, 3, generator=gen).repeat(8, 1, 1, 1))
        self.quant = QuantConv2d.from_conv(self.quant, act_scale=0.05)

    def forward(self, x):
        y = self.quant(self.msca(self.bank(self.lowrank(self.stem(x)))))
        return self.head(y.mean(dim=(2, 3)))


def mscan_d1fix(seed: int = 0):
    model = MSCAN_Classifier(**TINY)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = channels_last(model).eval()
    assert apply_app(model, MscaRep(decomp=1, fix=True), [], torch.Generator().manual_seed(0)) == 4
    return model


MODELS = {"MSCAN d1+fix": (mscan_d1fix, {"msca_fused": 4}),
          "kernel layers": (lambda: channels_last(KernelLayers(torch.Generator().manual_seed(1)))
                            .eval(),
                            {"lowrank_conv": 1, "parallel_cascade": 1, "msca_fused": 1,
                             "qmatmul": 1})}


def weights_are_read_not_computed(module):
    """Every tensor argument of every kernel op but its input is a placeholder
    of the loaded program (a parameter or a constant): nothing is packed per call."""
    placeholders = {n for n in module.graph.nodes if n.op in ("placeholder", "get_attr")}
    ops = [n for n in module.graph.nodes if n.op == "call_function"
           and getattr(n.target, "namespace", None) == "convnet_approximater_tpu_torch"]
    computed = [(n.name, a.name) for n in ops for a in n.args[1:]
                if isinstance(a, torch.fx.Node) and a not in placeholders]
    return not computed, computed


@pytest.mark.parametrize("name", sorted(MODELS))
def test_export_round_trip_holds_each_kernel(tmp_path, name):
    make, ops = MODELS[name]
    model = make()
    x = nchw(batch(2))
    with torch.no_grad():
        y_live = model(x).numpy()
    path = str(tmp_path / "model.pt2")
    data = deploy.export_serving(model, (x,), path=path)
    for source in (data, path):
        loaded = deploy.load_serving(source)
        with torch.no_grad():
            assert rel(loaded(x), y_live) <= LOADED_RTOL, name
        assert deploy.custom_op_counts(loaded) == ops
        ok, computed = weights_are_read_not_computed(loaded)
        assert ok, computed
        assert loaded.in_avals == (deploy.Aval((2, 3, 32, 32), torch.float32, "channels_last"),)
        assert loaded.out_avals[0].shape == (2, 10)
    # the live model keeps its own caches after the trace, and serves as before
    with torch.no_grad():
        assert np.array_equal(model(x).numpy(), y_live)


@pytest.fixture(scope="module")
def symbolic():
    model = MODELS["kernel layers"][0]()
    data = deploy.export_serving(model, (nchw(batch(4)),), symbolic_batch=True)
    return model, deploy.load_serving(data)


@pytest.mark.parametrize("b", [1, 3, 5])
def test_symbolic_batch_serves_any_batch(symbolic, b):
    model, loaded = symbolic
    assert loaded.in_avals[0].shape == (None, 3, 32, 32)
    assert loaded.batch_range == (1, deploy.MAX_SYMBOLIC_BATCH)  # on the card it starts at 2
    x = nchw(batch(b, seed=7))
    with torch.no_grad():
        assert rel(loaded(x), model(x)) <= LOADED_RTOL


def test_export_refuses_a_foreign_platform():
    model = mscan_d1fix()
    with pytest.raises(ValueError, match="export once per device"):
        deploy.export_serving(model, (nchw(batch(2)),), platforms=("cpu", "tpu"))


def test_frozen_keys_need_a_forward_first():
    """A cache the trace would read but no forward filled raises, rather than
    tracing the packing into the program."""
    layer = LowRankExpConvV1(4, 4, 3, 1, 1, num_base=2)
    with frozen_params_keys(), pytest.raises(RuntimeError, match="run an eval forward"):
        layer.packed()


def test_artifact_matches_the_jax_artifact():
    """A tiny MSCAN, the same weights in both packages, exported and loaded by
    each package's export_serving/load_serving on the CPU."""
    jmodel = JClassifier(**TINY)
    variables = drawn(jmodel, seed=3)
    model = port_of(MSCAN_Classifier(**TINY), variables)
    x = batch(2, seed=11)
    params, state = variables["params"], variables["state"]

    def fwd(p, xb):
        return jmodel.apply(p, xb, state=state, training=False)[0]

    jserved = jdeploy.load_serving(jdeploy.export_serving(fwd, (params, jnp.asarray(x))))
    served = deploy.load_serving(deploy.export_serving(model, (nchw(x),)))
    with torch.no_grad():
        y = served(nchw(x)).numpy()
    assert rel(y, np.asarray(jserved(params, jnp.asarray(x)))) <= JAX_RTOL
    assert deploy.custom_op_counts(served) == {"msca_fused": 4}


# -- the batch wrappers against the JAX package's -------------------------------
def tracked(calls, jax_side: bool):
    """A batch-major forward of either package that records each batch size."""
    w = np.random.RandomState(0).randn(3, 4).astype(np.float32)

    def fwd(x):
        calls.append(x.shape[0])
        if jax_side:
            return {"y": jnp.tanh(x.reshape(x.shape[0], -1)[:, :3] @ jnp.asarray(w))}
        return {"y": torch.tanh(x.reshape(x.shape[0], -1)[:, :3] @ torch.from_numpy(w))}
    return fwd


WRAPPERS = {
    "pad_batch": (lambda f, m: m.pad_batch(f, 4), [1, 3, 8]),
    "pad_batch_to_multiple": (lambda f, m: m.pad_batch_to_multiple(f, 4), [12, 5, 1]),
    "chunk_batch": (lambda f, m: m.chunk_batch(f, 4), [3, 10]),
    "chunk_batch(pad_batch)": (lambda f, m: m.chunk_batch(m.pad_batch(f, 2), 4), [1, 9]),
    "chunk_batch(pad_batch_to_multiple)": (
        lambda f, m: m.chunk_batch(m.pad_batch_to_multiple(f, 4), 8), [11]),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_batch_wrappers_match_jax(name):
    wrap, sizes = WRAPPERS[name]
    calls, jcalls = [], []
    served, jserved = wrap(tracked(calls, False), deploy), wrap(tracked(jcalls, True), jdeploy)
    for b in sizes:
        x = np.random.RandomState(b).randn(b, 2, 2, 3).astype(np.float32)
        y, jy = served(torch.from_numpy(x))["y"].numpy(), np.asarray(jserved(jnp.asarray(x))["y"])
        assert y.shape == jy.shape == (b, 4)
        assert np.abs(y - jy).max() <= 1e-6, (name, b)
    assert calls == jcalls


@pytest.mark.parametrize("name", ["pad_batch", "pad_batch_to_multiple", "chunk_batch"])
def test_batch_wrappers_refuse_batch_free_leaves(name):
    def fwd(x):
        return {"logits": x * 2.0, "aux_scalar": torch.tensor(1.0)}

    def jfwd(x):
        return {"logits": x * 2.0, "aux_scalar": jnp.float32(1.0)}

    wrap = {"pad_batch": lambda f, m: m.pad_batch(f, min_batch=4),
            "pad_batch_to_multiple": lambda f, m: m.pad_batch_to_multiple(f, 4),
            "chunk_batch": lambda f, m: m.chunk_batch(f, max_batch=2)}[name]
    b = {"pad_batch": 1, "pad_batch_to_multiple": 3, "chunk_batch": 5}[name]
    with pytest.raises(ValueError, match="no leading batch dim"):
        wrap(fwd, deploy)(torch.ones(b, 3))
    with pytest.raises(ValueError, match="no leading batch dim"):
        wrap(jfwd, jdeploy)(jnp.ones((b, 3)))


def test_pad_batch_to_multiple_refuses_a_multiple_below_one():
    with pytest.raises(ValueError, match="multiple=0"):
        deploy.pad_batch_to_multiple(lambda x: x, 0)
