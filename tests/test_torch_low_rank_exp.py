"""The port's LowRankExpV1 (initialize, optimize, postprocess) against the JAX app.

Both apps solve the same random ``Conv2d(6, 10, 5)``; the solved layers'
outputs, the PC energy and the ALS objective trace are compared.  Singular
vectors may come out with other signs than the JAX package's, which leaves
``A B`` and, after ``decomp``, each ``v x h`` unchanged, so the layers'
outputs are compared, not the raw factors.  Tolerance: 1e-5 relative, the
JAX kernel tests' bound, except 1e-4 for the SVD init followed by ``decomp``:
there each basis is cut to rank 1, which amplifies the rounding of the first
SVD (another LAPACK on each side) where a basis's top two singular values lie
close (3.5e-5 measured on this conv; ``decomp`` of identical weights agrees
to 1e-5, ``tests/test_torch_lowrank_conv.py``).
"""

import logging
import re
from contextlib import contextmanager

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

from convnet_approximater_tpu.core import LowRankExpV1 as JLowRankExpV1  # noqa: E402
from convnet_approximater_tpu.core import low_rank_solvers as jsolvers  # noqa: E402
from convnet_approximater_tpu.nn import Conv2d as JConv2d  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import LowRankExpV1  # noqa: E402
from convnet_approximater_tpu_torch.core import low_rank_solvers as solvers  # noqa: E402
from convnet_approximater_tpu_torch.layers import LowRankExpConvV1  # noqa: E402
from convnet_approximater_tpu_torch.nn import Conv2d  # noqa: E402

torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@contextmanager
def jax_log():
    """Collect the JAX package's log messages."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger("convnet_approximater_tpu")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield records
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


@pytest.fixture(scope="module")
def source():
    conv = JConv2d(6, 10, 5, padding=2)
    params = conv.init(jax.random.key(0))
    x = np.random.RandomState(1).randn(2, 12, 12, 6).astype(np.float32)
    return conv, params, x


def torch_conv(params):
    conv = Conv2d(6, 10, 5, padding=2)
    flat = flatten_tree({"params": params})
    conv.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in flat.items()}))
    return conv


def solve_jax(source, kw):
    conv, params, x = source
    app = JLowRankExpV1(**kw)
    sub, sparams = app.initialize(conv, params, jax.random.key(1))
    with jax_log() as log:
        app.optimize(sub, sparams)
    mod, new = app.postprocess(sub, sparams)
    y = np.asarray(mod.apply(new, jax.numpy.asarray(x))[0])
    objs = [float(re.search(r"total error: (\S+)", m).group(1)) for m in log if "total error" in m]
    pce = [float(m.split("= ")[1]) for m in log if m.startswith("PC Energy")]
    return mod, y, objs, pce[-1]


def solve_torch(source, kw):
    _, params, x = source
    app = LowRankExpV1(**kw)
    sub = app.initialize(torch_conv(params))
    app.optimize(sub)
    mod = app.postprocess(sub).eval()
    with torch.no_grad():
        y = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    return mod, y, app.objectives, app.pc_energy


CASES = [  # (init, do_decomp, max_iter, tolerance)
    ("svd", False, 0, 1e-5),
    ("svd", True, 0, 1e-4),
    ("standard", False, 0, 1e-5),
    ("standard", True, 0, 1e-5),
    ("svd", False, 3, 1e-5),
    ("standard", True, 3, 1e-5),
]


@pytest.mark.parametrize("init,do_decomp,max_iter,tol", CASES)
def test_app_matches_jax(source, init, do_decomp, max_iter, tol):
    # two lambdas > 0 when the ALS runs, so the nuclear prox runs too; epsilon 0
    # runs every iteration on both sides (the JAX app checks convergence only
    # after a chunk of iterations, the port after each one)
    lmda = dict(lmda_length=2, min_lmda=0.01, max_lmda=0.1) if max_iter else {}
    kw = dict(num_bases=(4,), max_iter=max_iter, init_method=init, do_decomp=do_decomp,
              epsilon=0.0, **lmda)
    jmod, y_j, objs_j, pce_j = solve_jax(source, kw)
    mod, y, objs, pce = solve_torch(source, kw)
    with torch.no_grad():  # the kernel route: no gradient can be asked
        assert isinstance(mod, LowRankExpConvV1) and mod.uses_kernel()
    assert hasattr(mod.s_conv, "v_conv") == do_decomp == hasattr(jmod.s_conv, "v_conv")
    assert y.shape == y_j.shape == (2, 12, 12, 10)
    assert rel(y, y_j) < tol
    assert len(objs) == len(objs_j) == 2 * max_iter
    if objs:
        np.testing.assert_allclose(objs, objs_j, rtol=tol)
    np.testing.assert_allclose(pce, pce_j, rtol=tol)


def test_random_init_shapes(source):
    _, params, x = source
    kw = dict(num_bases=(4,), init_method="random")
    mods = []
    for _ in range(2):
        app = LowRankExpV1(**kw)
        sub = app.initialize(torch_conv(params))
        app.optimize(sub)
        mods.append(app.postprocess(sub))
    assert tuple(mods[0].s_conv.weight.shape) == (24, 1, 5, 5)
    assert tuple(mods[0].d_conv.weight.shape) == (10, 24, 1, 1)
    assert torch.equal(mods[0].s_conv.weight, mods[1].s_conv.weight)  # seeded, as JAX's key(0)
    with torch.no_grad():
        y = mods[0].eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert y.shape == (2, 10, 12, 12) and torch.isfinite(y).all()


def test_bias_carried_to_mixing_conv(source):
    _, params, _ = source
    conv = torch_conv(params)
    sub = LowRankExpV1(num_bases=(4,)).initialize(conv)
    assert torch.equal(sub.new_module.d_conv.bias, conv.bias)
    bare = Conv2d(6, 10, 5, padding=2, bias=False)
    sub = LowRankExpV1(num_bases=(4,)).initialize(bare)
    assert torch.count_nonzero(sub.new_module.d_conv.bias) == 0


@pytest.mark.parametrize("energy", [0.5, 0.9, 1.0])
def test_energy_picks_the_jax_rank(source, energy):
    conv, params, _ = source
    japp = JLowRankExpV1(energy=energy)
    jsub, _ = japp.initialize(conv, params, jax.random.key(1))
    sub = LowRankExpV1(energy=energy).initialize(torch_conv(params))
    assert sub.new_module.num_base == jsub.new_module.num_base


def test_solver_pieces_match_jax():
    rs = np.random.RandomState(2)
    W = rs.randn(60, 25).astype(np.float32)
    B = rs.randn(4, 25).astype(np.float32)
    A = rs.randn(60, 4).astype(np.float32)
    jW, jA, jB = (jax.numpy.asarray(a) for a in (W, A, B))
    tW, tA, tB = (torch.from_numpy(a) for a in (W, A, B))
    assert rel(solvers.l21_objective(tW, tA, tB, 0.3, 5).item(),
               jsolvers.l21_objective(jW, jA, jB, 0.3, 5)) < 1e-5
    assert rel(solvers._svt(tB, 5, 0.5).numpy(), jsolvers._svt(jB, 5, 0.5)) < 1e-5
    assert rel(solvers.pc_energy(tB, 5).item(), jsolvers.pc_energy(jB, 5)) < 1e-5
    zero = np.zeros_like(B)
    assert rel(solvers.pc_energy(torch.from_numpy(zero), 5).item(),
               jsolvers.pc_energy(jax.numpy.asarray(zero), 5)) < 1e-5
    for args in [(1, 0.0, 0.0), (3, 0.01, 0.1), (5, 0.0, 1.0, 2.0)]:
        np.testing.assert_array_equal(solvers.lmda_schedule(*args), jsolvers.lmda_schedule(*args))


@pytest.mark.parametrize("bad", [dict(), dict(num_bases=(4,), energy=0.9),
                                 dict(energy=1.5), dict(num_bases=(4,), init_method="pca"),
                                 dict(num_bases=(4,), min_lmda=0.2, max_lmda=0.1)])
def test_app_rejects_bad_options(bad):
    with pytest.raises(ValueError):
        LowRankExpV1(**bad)
