"""The port's scheme-1 low-rank conv against the JAX package.

``lowrank_conv_ref`` (what the wrapper runs on CPU tensors, and what the CUDA
kernel is checked against on the card) is held against the JAX Pallas
``lowrank_conv`` in interpret mode on the same weights, in both forms
(separable and full bases), at strides 1 and 2 and on a rectangular map: the
cases of ``tests/test_lowrank_kernel.py``.  ``LowRankExpConvV1`` is held
against the JAX module's ``apply`` on carried-across weights, on the dispatch
path (eval) and on the module path (training).  Tolerance: 1e-5 relative, the
JAX kernel tests' bound; the two sides sum in another order (the JAX module
path runs the vertical pass first, the kernels the horizontal one).
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

from convnet_approximater_tpu.core import LowRankExpV1 as JLowRankExpV1  # noqa: E402
from convnet_approximater_tpu.nn import Conv2d as JConv2d  # noqa: E402
from convnet_approximater_tpu.ops.pallas import lowrank_conv as jlowrank_conv  # noqa: E402
from convnet_approximater_tpu.ops.pallas import (  # noqa: E402
    lowrank_params_from_module as jlowrank_params)
from convnet_approximater_tpu.utils.serialize import flatten_tree  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.layers import LowRankExpConvV1  # noqa: E402
from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def jax_layer(do_decomp, C=6, N=10, d=5, M=4, stride=1, padding=2):
    """A JAX LowRankExpConvV1 solved from a random conv by the SVD init."""
    conv = JConv2d(C, N, d, stride=stride, padding=padding)
    app = JLowRankExpV1(num_bases=(M,), max_iter=0, lmda_length=1, min_lmda=0, max_lmda=0,
                        init_method="svd", do_decomp=do_decomp)
    sub, sparams = app.initialize(conv, conv.init(jax.random.key(0)), jax.random.key(1))
    app.optimize(sub, sparams)
    return app.postprocess(sub, sparams)


def torch_layer(jmod, params):
    """The port's layer of the same structure, holding the JAX ``params``."""
    mod = LowRankExpConvV1(jmod.in_channels, jmod.out_channels, jmod.kernel_size, jmod.stride,
                           jmod.padding, jmod.num_base,
                           decomp=hasattr(jmod.s_conv, "v_conv"))
    flat = flatten_tree({"params": params})
    mod.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in flat.items()}))
    return mod.eval()


def nhwc(B, H, W, C, seed):
    return np.random.RandomState(seed).randn(B, H, W, C).astype(np.float32)


def run_torch(mod, x):
    with torch.no_grad():
        return mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


CASES = [  # (do_decomp, stride, layer kwargs, x shape)
    (False, 1, {}, (2, 13, 13, 6)),
    (True, 1, {}, (2, 13, 13, 6)),
    (False, 2, {}, (2, 13, 13, 6)),
    (True, 2, {}, (2, 13, 13, 6)),
    (False, 1, dict(d=3, padding=1), (1, 9, 11, 6)),
    (True, 1, dict(d=3, padding=1), (1, 9, 11, 6)),
]


@pytest.mark.parametrize("do_decomp,stride,kw,shape", CASES)
def test_ref_matches_pallas_interpret(do_decomp, stride, kw, shape):
    jmod, params = jax_layer(do_decomp, stride=stride, **kw)
    x = nhwc(*shape, seed=2)
    jw = jlowrank_params(params, jmod)
    y_pallas = jlowrank_conv(jax.numpy.asarray(x), jw.pop("A_mc"), jw.pop("b"),
                             kernel_size=jmod.kernel_size, stride=jmod.stride,
                             padding=jmod.padding, interpret=True, **jw)
    tw = lowrank_ops.lowrank_params_from_module(torch_layer(jmod, params))
    y = lowrank_ops.lowrank_conv_ref(torch.from_numpy(x), tw.pop("A_mc"), tw.pop("b"),
                                     kernel_size=jmod.kernel_size, stride=jmod.stride,
                                     padding=jmod.padding, **tw)
    assert y.shape == y_pallas.shape
    assert rel(y.numpy(), y_pallas) < RTOL


@pytest.mark.parametrize("do_decomp", [False, True])
def test_params_from_module_equal_jax(do_decomp):
    jmod, params = jax_layer(do_decomp, stride=2)
    jw = jlowrank_params(params, jmod)
    tw = lowrank_ops.lowrank_params_from_module(torch_layer(jmod, params))
    assert sorted(tw) == sorted(jw)
    for k in jw:
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]))
        assert tw[k].is_contiguous()


@pytest.mark.parametrize("do_decomp,stride,kw,shape", CASES)
def test_layer_matches_jax_module(do_decomp, stride, kw, shape):
    jmod, params = jax_layer(do_decomp, stride=stride, **kw)
    x = nhwc(*shape, seed=3)
    y_j = np.asarray(jmod.apply(params, jax.numpy.asarray(x))[0])
    mod = torch_layer(jmod, params)
    with torch.no_grad():  # the kernel route: no gradient can be asked
        assert mod.uses_kernel()
    before = lowrank_ops.lowrank_conv.launches
    assert rel(run_torch(mod, x), y_j) < RTOL  # eval: lowrank_conv -> lowrank_conv_ref on the CPU
    assert lowrank_ops.lowrank_conv.launches == before  # the CPU path launches nothing
    mod.train()  # the module path: s_conv -> d_conv
    assert not mod.uses_kernel()
    assert rel(run_torch(mod, x), y_j) < RTOL


@pytest.mark.parametrize("do_decomp", [False, True])
def test_per_channel_bases_take_the_module_path(do_decomp):
    """Fine-tuned bases differ per input channel; the kernel (which reads
    channel 0's) must not run them."""
    jmod, params = jax_layer(do_decomp)
    flat = {k: np.asarray(v) for k, v in flatten_tree({"params": params}).items()}
    key = "params/s_conv/h_conv/weight" if do_decomp else "params/s_conv/weight"
    flat[key] = flat[key] + 0.05 * np.random.RandomState(4).randn(*flat[key].shape).astype(
        np.float32)
    from convnet_approximater_tpu.utils.serialize import unflatten_tree

    params = unflatten_tree(flat)["params"]
    x = nhwc(2, 11, 11, 6, seed=5)
    y_j = np.asarray(jmod.apply(params, jax.numpy.asarray(x))[0])
    mod = torch_layer(jmod, params)
    assert not mod.bases_shared() and not mod.uses_kernel()
    assert rel(run_torch(mod, x), y_j) < RTOL


def test_pack_follows_weight_changes():
    """The packed weights are reused while the parameters are unchanged and
    packed (and checked) again after an in-place update."""
    jmod, params = jax_layer(True)
    mod = torch_layer(jmod, params)
    first = mod.packed()
    assert mod.packed() is first
    b = first["b"].clone()
    with torch.no_grad():
        mod.d_conv.bias.add_(1.0)
    second = mod.packed()
    assert second is not first
    assert torch.equal(second["b"], b + 1.0)
    with torch.no_grad():
        mod.s_conv.h_conv.weight[0, 0, 0, 0] += 1.0  # channel 0's taps now differ
    assert mod.packed() is None and not mod.uses_kernel()


def test_decomp_matches_jax_decomp():
    """The port's decomp() of the solved layer against the JAX app's do_decomp
    on the same weights (both SVDs' signs are free; the outputs are compared)."""
    jdec, dparams = jax_layer(True)
    mod = torch_layer(*jax_layer(False))
    mod.decomp()
    with torch.no_grad():
        assert hasattr(mod.s_conv, "v_conv") and mod.uses_kernel()
    x = nhwc(2, 12, 12, 6, seed=6)
    assert rel(run_torch(mod, x), np.asarray(jdec.apply(dparams, jax.numpy.asarray(x))[0])) < RTOL


def _args(form="sep", M=3, C=4, N=5, k=3):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    taps = dict(v=r(M, k), h=r(M, k)) if form == "sep" else dict(bases=r(M, k, k))
    return [r(2, 7, 8, C), r(M * C, N), r(N)], dict(kernel_size=(k, k), stride=(1, 2),
                                                    padding=(1, 1), **taps)


@pytest.mark.parametrize("bad,error", [
    (lambda a, kw: a.__setitem__(0, a[0].double()), TypeError),                   # dtype
    (lambda a, kw: a.__setitem__(0, a[0].transpose(1, 2)), ValueError),           # contiguity
    (lambda a, kw: a.__setitem__(1, a[1][:-1]), ValueError),                      # A_mc rows
    (lambda a, kw: a.__setitem__(2, a[2][:-1]), ValueError),                      # bias
    (lambda a, kw: kw.pop("h"), ValueError),                                      # half a pair
    (lambda a, kw: kw.update(bases=torch.zeros(3, 3, 3)), ValueError),            # both forms
    (lambda a, kw: kw.update(kernel_size=(3, 5)), ValueError),                    # h taps
    (lambda a, kw: kw.update(padding=(0, 0), kernel_size=(9, 3),                  # empty output
                             v=torch.zeros(3, 9)), ValueError),
])
def test_wrapper_rejects_bad_inputs(bad, error):
    args, kw = _args()
    bad(args, kw)
    with pytest.raises(error):
        lowrank_ops.lowrank_conv(*args, **kw)


def test_wrapper_rejects_unknown_device():
    args, kw = _args()
    args = [a.to("meta") for a in args]
    kw = {k: v.to("meta") if torch.is_tensor(v) else v for k, v in kw.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        lowrank_ops.lowrank_conv(*args, **kw)


@pytest.mark.parametrize("form", ["sep", "full"])
def test_wrapper_cpu_equals_ref(form):
    args, kw = _args(form)
    y = lowrank_ops.lowrank_conv(*args, **kw)
    assert y.shape == (2, 7, 4, 5)
    assert torch.equal(y, lowrank_ops.lowrank_conv_ref(*args, **kw))


def _fake_nvcc(tmp_path, fail_on=None):
    """A stand-in for nvcc that writes its ``-o`` target (or fails on one source)."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        "out=''; prev=''; last=''\n"
        "for a in \"$@\"; do [ \"$prev\" = '-o' ] && out=\"$a\"; prev=\"$a\"; last=\"$a\"; done\n"
        f"case \"$last\" in *{fail_on or 'no-such-source'}) echo 'error: bad' ; exit 2;; esac\n"
        "echo 'ptxas info' ; echo lib > \"$out\"\n")
    script.chmod(0o755)
    return str(script)


def test_build_all_builds_in_parallel_and_reuses(tmp_path, monkeypatch):
    from convnet_approximater_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "find_nvcc", lambda: _fake_nvcc(tmp_path))
    sources = ["msca_fused.cu", "lowrank_conv.cu"]
    seconds = build.build_all(sources)
    assert sorted(seconds) == sorted(sources) and all(t > 0 for t in seconds.values())
    for s in sources:
        lib = build.library_path(s)
        assert lib.read_text() == "lib\n" and "ptxas info" in lib.with_suffix(".log").read_text()
    assert build.build_all(sources) == {s: 0.0 for s in sources}  # built already
    assert not list((tmp_path / "out").glob("*.tmp"))


def test_build_all_reports_a_failed_source(tmp_path, monkeypatch):
    from convnet_approximater_tpu_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "find_nvcc", lambda: _fake_nvcc(tmp_path, "lowrank_conv.cu"))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed on lowrank_conv.cu.*error: bad"):
        build.build_all(["msca_fused.cu", "lowrank_conv.cu"])
    assert build.library_path("msca_fused.cu").exists()  # the other build finished
    assert not build.library_path("lowrank_conv.cu").exists()
