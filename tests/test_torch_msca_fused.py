"""The port's fused MSCA block against the JAX package.

``msca_fused_ref`` (what the wrapper runs on CPU tensors, and what the CUDA
kernel is checked against on the card) is held against JAX's ``MSCA.apply``
lax path, and against JAX's Pallas ``msca_fused`` in interpret mode where the
two JAX paths agree.  Tolerance: 1e-5 relative, the JAX kernel tests' bound.

The Pallas kernel disagrees with its own module when the map is lower than
``2 * fix_p`` (its border strip is ``concatenate([top, bot])[:H]``, where
``FixPaddingBias`` adds both strips and aligns the bottom one to the last
row); the port follows the module, and one test pins that reference fault.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402

from convnet_approximater_tpu.core import MscaRep as JMscaRep  # noqa: E402
from convnet_approximater_tpu.layers import MSCA as JMSCA  # noqa: E402
from convnet_approximater_tpu.utils.serialize import flatten_tree  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.core import MscaRep  # noqa: E402
from convnet_approximater_tpu_torch.layers import MSCA  # noqa: E402
from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-5
C = 8


def rel(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def jax_msca(decomp, seed=0):
    """A JAX MSCA (7, 11, 21) with random weights, MscaRep'd when decomp is set."""
    msca = JMSCA(C, 5, (7, 11, 21))
    params = msca.init(jax.random.key(seed))
    if decomp is None:
        return msca, params
    app = JMscaRep(decomp=decomp, fix=True)
    sub, sparams = app.initialize(msca, params, jax.random.key(seed + 1))
    app.optimize(sub, sparams)
    return sub.new_module, sparams["new"]


def torch_msca(decomp, params):
    """The port's MSCA of the same structure, holding the JAX ``params``."""
    m = MSCA(C, 5, (7, 11, 21))
    if decomp is not None:
        m = MscaRep(decomp=decomp, fix=True).initialize(m).new_module
    flat = flatten_tree({"params": params})
    m.load_state_dict(params_from_jax({k: np.asarray(v) for k, v in flat.items()}))
    return m.eval()


def run_torch(m, x):
    with torch.no_grad():
        return m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


def nhwc(H, W, seed=3):
    return np.random.RandomState(seed).randn(2, H, W, C).astype(np.float32)


CASES = [  # (decomp, H): decomp None is the dense bank (7, 11, 21) + identity
    (None, 14), (None, 28), (1, 7), (1, 14), (1, 28), (2, 14), (4, 14),
]


@pytest.mark.parametrize("decomp,H", CASES)
def test_fused_ref_matches_jax_module(decomp, H):
    jm, params = jax_msca(decomp)
    x = nhwc(H, H + 3)
    y_lax, _, _ = jm.apply(params, jax.numpy.asarray(x))
    tm = torch_msca(decomp, params)
    with torch.no_grad():  # the kernel route: no gradient can be asked
        assert tm.can_fuse()
    before = fused_ops.msca_fused.launches
    y = run_torch(tm, x)  # eval forward -> msca_fused -> msca_fused_ref on the CPU
    assert fused_ops.msca_fused.launches == before  # the CPU path launches nothing
    assert rel(y, np.asarray(y_lax)) < RTOL
    # the module path (what a training forward takes) agrees as well
    tm.train()
    assert not tm.can_fuse()
    assert rel(run_torch(tm, x), np.asarray(y_lax)) < RTOL


@pytest.mark.parametrize("decomp,H", [(None, 12), (1, 20), (1, 28), (2, 22)])
def test_fused_ref_matches_pallas_interpret(decomp, H):
    """Where H >= 2 fix_p, JAX's Pallas kernel (interpret mode) is a second reference."""
    jm, params = jax_msca(decomp, seed=5)
    x = nhwc(H, H - 2, seed=6)
    y_pallas = np.asarray(jm._fused_forward(params, jax.numpy.asarray(x), interpret=True))
    assert rel(run_torch(torch_msca(decomp, params), x), y_pallas) < RTOL


@pytest.mark.parametrize("H", [7, 14])
def test_pallas_border_fix_fault_below_two_fix_p(H):
    """Reference fault: for H < 2 fix_p (MSCAN-t's 14x14 and 7x7 stages at
    224^2, fix_p = 10) the Pallas kernel's concatenated strip differs from
    FixPaddingBias.  The port follows FixPaddingBias."""
    jm, params = jax_msca(1, seed=7)
    x = nhwc(H, H, seed=8)
    y_lax = np.asarray(jm.apply(params, jax.numpy.asarray(x))[0])
    y_pallas = np.asarray(jm._fused_forward(params, jax.numpy.asarray(x), interpret=True))
    assert rel(y_pallas, y_lax) > 1e-3
    assert rel(run_torch(torch_msca(1, params), x), y_lax) < RTOL


def test_pack_cascade_weights_matches_jax():
    from convnet_approximater_tpu.ops.pallas import pack_cascade_weights as jpack

    rs = np.random.RandomState(9)
    w1 = [rs.randn(k, C).astype(np.float32) for k in (7, 11, 21)]
    w2 = [rs.randn(k, C).astype(np.float32) for k in (7, 11, 21)]
    b1 = [rs.randn(C).astype(np.float32), None, rs.randn(C).astype(np.float32)]
    b2 = [None, rs.randn(C).astype(np.float32), rs.randn(C).astype(np.float32)]
    ours = fused_ops.pack_cascade_weights(
        [torch.from_numpy(w) for w in w1], [None if b is None else torch.from_numpy(b) for b in b1],
        [torch.from_numpy(w) for w in w2], [None if b is None else torch.from_numpy(b) for b in b2])
    theirs = jpack([jax.numpy.asarray(w) for w in w1], b1, [jax.numpy.asarray(w) for w in w2], b2)
    assert ours[4] == theirs[4] == (7, 11, 21)
    for a, b in zip(ours[:4], theirs[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _args(H=9, nb=1, fix_p=10):
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return [r(2, H, H, C), r(5, 5, C), r(C), r(nb, 21, C), r(nb, C), r(nb, 21, C), r(nb, C),
            r(C, C), r(C), r(2, fix_p, C)]


@pytest.mark.parametrize("bad,error", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError),                       # dtype
    (lambda a: a.__setitem__(0, a[0].transpose(1, 2)), ValueError),               # contiguity
    (lambda a: a.__setitem__(7, a[7][:, :4]), ValueError),                        # wm shape
    (lambda a: a.__setitem__(9, None), ValueError),                               # res missing
    (lambda a: a.__setitem__(1, torch.randn(4, 4, C)), ValueError),               # even k0
])
def test_wrapper_rejects_bad_inputs(bad, error):
    args = _args()
    bad(args)
    with pytest.raises(error):
        fused_ops.msca_fused(*args, ks=(21,), identity=False, fix_p=10)


def test_wrapper_rejects_unknown_device():
    args = [a.to("meta") for a in _args()]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ops.msca_fused(*args, ks=(21,), identity=False, fix_p=10)


def test_wrapper_cpu_equals_ref():
    args = _args(H=7)
    y = fused_ops.msca_fused(*args, ks=(21,), identity=False, fix_p=10)
    y_ref = fused_ops.msca_fused_ref(*args, ks=(21,), identity=False, fix_p=10)
    assert y.shape == args[0].shape and torch.equal(y, y_ref)
