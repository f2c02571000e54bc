"""The four kernels' plain versions in bf16 against the JAX package's kernels.

Each plain version takes bf16 x as the CUDA kernels do: x upcast (exactly),
the float32 arithmetic, one rounding to bf16.  Held on the same bf16 inputs,
with the weights as float32 copies of bf16 values (what the port packs):

* ``msca_fused_ref``, ``parallel_cascade_ref`` and ``lowrank_conv_ref``
  against the Pallas kernels in interpret mode, which also read bf16 x,
  compute in float32 and write bf16.  Each element lies within one bf16 ulp
  of JAX's, except where the float32 result is a cancellation (a value far
  below its terms): there the two float32 results' own difference is added
  to the ulp, and those elements are counted.
* ``qmatmul_ref`` against ``scripts/exp_pallas_qmatmul.py``'s ``xla_qmatmul``
  (the function that the Pallas probe computes), bit for bit: the integer
  sums are exact and the float32 epilogue is the same three roundings.
* The four ``torch.library`` ops: their CPU implementation on bf16 x gives the
  plain version's bf16 bits, and their fake kernels give bf16 outputs, so that
  ``torch.export`` records bf16 avals.
"""

import ast
import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from convnet_approximater_tpu.ops.pallas import lowrank_conv as jlowrank_conv  # noqa: E402
from convnet_approximater_tpu.ops.pallas import msca_fused as jmsca_fused  # noqa: E402
from convnet_approximater_tpu.ops.pallas import parallel_cascade as jparallel_cascade  # noqa: E402
from convnet_approximater_tpu_torch.ops import lowrank_conv as lowrank_ops  # noqa: E402
from convnet_approximater_tpu_torch.ops import msca_fused as fused_ops  # noqa: E402
from convnet_approximater_tpu_torch.ops import parallel_cascade as cascade_ops  # noqa: E402
from convnet_approximater_tpu_torch.ops import qmatmul as qmatmul_ops  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -7  # one bf16 ulp of a value v is at most |v| 2^-7
RS = np.random.RandomState(17)


@pytest.fixture(autouse=True)
def seeded():
    RS.seed(17)  # each test draws the same values, alone or after the others


def bf16_values(*shape, scale=1.0):
    """float32 numpy values that bf16 holds exactly (what bf16 weights upcast give)."""
    t = torch.from_numpy((RS.randn(*shape) * scale).astype(np.float32))
    return t.to(torch.bfloat16).float().numpy()


def bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def xla_qmatmul():
    """``xla_qmatmul`` of scripts/exp_pallas_qmatmul.py, compiled from its source
    alone (the script's module body sets a JAX cache and imports the bench)."""
    path = os.path.join(REPO, "scripts", "exp_pallas_qmatmul.py")
    tree = ast.parse(open(path).read())
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "xla_qmatmul")
    namespace = {"jax": jax, "jnp": jnp}
    exec(compile(ast.Module(body=[node], type_ignores=[]), path, "exec"), namespace)
    return namespace["xla_qmatmul"]


def hold_within_one_ulp(port, jax_out, float32_pair):
    """bf16 ``port`` against bf16 ``jax_out`` (numpy float32 views): within one
    ulp, plus the float32 results' difference (``float32_pair()``: both
    functions on the upcast input, run only where an element needs it) where
    they cancel.  Returns the count of elements beyond one ulp."""
    diff = np.abs(port - jax_out)
    scale = np.maximum(np.abs(port), np.abs(jax_out))
    assert np.isfinite(port).all() and port.shape == jax_out.shape
    over = int((diff > scale * BF16_ULP).sum())
    if over:
        port32, jax32 = float32_pair()
        assert (diff <= scale * BF16_ULP + np.abs(port32 - jax32)).all()
    assert over <= 0.01 * port.size  # cancellations are rare
    return over


# -- msca_fused ----------------------------------------------------------------
MSCA_FORMS = {"dense bank": ((7, 11, 21), True, 0), "d1+fix": ((21,), False, 10)}


@pytest.mark.parametrize("form", sorted(MSCA_FORMS))
def test_msca_fused_ref_in_bf16_matches_pallas(form):
    ks, identity, fix_p = MSCA_FORMS[form]
    C, H, W = 8, 20, 23
    w1, b1, w2, b2 = ([bf16_values(k, C, scale=k ** -0.5) for k in ks],
                      [bf16_values(C, scale=0.2) for _ in ks],
                      [bf16_values(k, C, scale=k ** -0.5) for k in ks],
                      [bf16_values(C, scale=0.2) for _ in ks])
    packed = fused_ops.pack_cascade_weights(*([torch.from_numpy(a) for a in t]
                                              for t in (w1, b1, w2, b2)))
    w = [bf16_values(5, 5, C, scale=0.2), bf16_values(C, scale=0.2), *(
        p.numpy() for p in packed[:4]), bf16_values(C, C, scale=C ** -0.5),
        bf16_values(C, scale=0.2)]
    res = bf16_values(2, fix_p, C) if fix_p else None
    x = torch.from_numpy(RS.randn(2, H, W, C).astype(np.float32)).to(torch.bfloat16)
    kw = dict(ks=ks, identity=identity, fix_p=fix_p)

    def port(xt):
        return fused_ops.msca_fused_ref(xt, *(torch.from_numpy(a) for a in w),
                                        None if res is None else torch.from_numpy(res), **kw)

    def pallas(xj):
        return np.asarray(jmsca_fused(xj, *(jnp.asarray(a) for a in w),
                                      None if res is None else jnp.asarray(res),
                                      interpret=True, **kw).astype(jnp.float32))

    y = port(x)
    assert y.dtype == torch.bfloat16
    y_j = pallas(jnp.asarray(bf16_np(x)).astype(jnp.bfloat16))
    hold_within_one_ulp(bf16_np(y), y_j, lambda: (port(x.float()).numpy(),
                                                  pallas(jnp.asarray(bf16_np(x)))))


# -- parallel_cascade ----------------------------------------------------------
@pytest.mark.parametrize("ks,identity", [((7,), False), ((7, 11, 21), True)],
                         ids=["rank-1 cascade", "MSCA bank"])
def test_parallel_cascade_ref_in_bf16_matches_pallas(ks, identity):
    C = 8
    packed = fused_ops.pack_cascade_weights(
        [torch.from_numpy(bf16_values(k, C, scale=k ** -0.5)) for k in ks],
        [torch.from_numpy(bf16_values(C, scale=0.2)) for _ in ks],
        [torch.from_numpy(bf16_values(k, C, scale=k ** -0.5)) for k in ks],
        [torch.from_numpy(bf16_values(C, scale=0.2)) for _ in ks])
    taps, ks = packed[:4], packed[4]
    x = torch.from_numpy(RS.randn(2, 14, 17, C).astype(np.float32)).to(torch.bfloat16)

    def pallas(xj):
        return np.asarray(jparallel_cascade(xj, *(jnp.asarray(t.numpy()) for t in taps), ks=ks,
                                            identity=identity, interpret=True)
                          .astype(jnp.float32))

    y = cascade_ops.parallel_cascade_ref(x, *taps, ks=ks, identity=identity)
    assert y.dtype == torch.bfloat16
    y32 = cascade_ops.parallel_cascade_ref(x.float(), *taps, ks=ks, identity=identity)
    assert torch.equal(y, y32.to(torch.bfloat16))  # one rounding of the float32 sums
    hold_within_one_ulp(bf16_np(y), pallas(jnp.asarray(bf16_np(x)).astype(jnp.bfloat16)),
                        lambda: (y32.numpy(), pallas(jnp.asarray(bf16_np(x)))))


# -- lowrank_conv --------------------------------------------------------------
@pytest.mark.parametrize("form", ["separable", "full bases"])
def test_lowrank_conv_ref_in_bf16_matches_pallas(form):
    C, M, N, k = 6, 4, 10, 3
    taps = (dict(v=bf16_values(M, k), h=bf16_values(M, k)) if form == "separable"
            else dict(bases=bf16_values(M, k, k)))
    A, b = bf16_values(M * C, N, scale=(M * C) ** -0.5), bf16_values(N, scale=0.1)
    x = torch.from_numpy(RS.randn(2, 9, 8, C).astype(np.float32)).to(torch.bfloat16)
    conv = dict(kernel_size=(k, k), stride=(2, 1), padding=(1, 1))

    def port(xt):
        return lowrank_ops.lowrank_conv_ref(xt, torch.from_numpy(A), torch.from_numpy(b),
                                            **{n: torch.from_numpy(t) for n, t in taps.items()},
                                            **conv)

    def pallas(xj):
        return np.asarray(jlowrank_conv(xj, jnp.asarray(A), jnp.asarray(b), interpret=True,
                                        **{n: jnp.asarray(t) for n, t in taps.items()}, **conv)
                          .astype(jnp.float32))

    y = port(x)
    assert y.dtype == torch.bfloat16
    hold_within_one_ulp(bf16_np(y), pallas(jnp.asarray(bf16_np(x)).astype(jnp.bfloat16)),
                        lambda: (port(x.float()).numpy(), pallas(jnp.asarray(bf16_np(x)))))


# -- qmatmul -------------------------------------------------------------------
@pytest.mark.parametrize("bias", [True, False])
def test_qmatmul_ref_in_bf16_matches_xla_qmatmul_bit_for_bit(bias):
    M, K, N = 37, 70, 19
    x = torch.from_numpy(RS.randn(M, K).astype(np.float32)).to(torch.bfloat16)
    w_q = torch.from_numpy(RS.randint(-127, 128, (N, K)).astype(np.int8))
    a = np.float32(float(x.float().abs().max()) / 127.0)
    w_scale = (RS.rand(N) * 0.01).astype(np.float32)
    b = RS.randn(N).astype(np.float32)
    y = qmatmul_ops.qmatmul_ref(x, qmatmul_ops.pack_qweight(w_q), torch.tensor(a),
                                torch.from_numpy(w_scale), torch.from_numpy(b) if bias else None)
    y_j = xla_qmatmul()(jnp.asarray(bf16_np(x)).astype(jnp.bfloat16), jnp.asarray(w_q.numpy().T),
                        jnp.asarray([a]), jnp.asarray(w_scale),
                        jnp.asarray(b if bias else np.zeros(N, np.float32)))
    assert y.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(bf16_np(y), np.asarray(y_j.astype(jnp.float32)))


# -- the custom ops in bf16: CPU implementations and fake kernels ------------------
def op_cases():
    """{op: (the op, its arguments on bf16 x, the plain version's result)}."""
    g = torch.Generator().manual_seed(5)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    C = 8
    w1, b1, w2, b2, ks = fused_ops.pack_cascade_weights([r(21, C)], [r(C)], [r(21, C)], [r(C)])
    x = r(2, 12, 12, C).to(torch.bfloat16)
    mw = (r(5, 5, C), r(C), w1, b1, w2, b2, r(C, C), r(C), r(2, 10, C))
    A, b, v, h = r(4 * C, 6), r(6), r(4, 3), r(4, 3)
    conv = dict(kernel_size=(3, 3), stride=(1, 1), padding=(1, 1))
    w_q = torch.randint(-127, 128, (5, 33), generator=g, dtype=torch.int8)
    qargs = (r(7, 33).to(torch.bfloat16), qmatmul_ops.pack_qweight(w_q), torch.tensor(0.02),
             r(5).abs(), r(5))
    return {
        "msca_fused": (fused_ops.msca_fused_op, (x, *mw, list(ks), False, 10),
                       lambda: fused_ops.msca_fused_ref(x, *mw, ks=ks, identity=False, fix_p=10)),
        "parallel_cascade": (cascade_ops.parallel_cascade_op, (x, w1, b1, w2, b2, list(ks), True),
                             lambda: cascade_ops.parallel_cascade_ref(x, w1, b1, w2, b2, ks=ks,
                                                                      identity=True)),
        "lowrank_conv": (lowrank_ops.lowrank_conv_op,
                         (x, A, b, v, h, None, None, None, [3, 3], [1, 1], [1, 1]),
                         lambda: lowrank_ops.lowrank_conv_ref(x, A, b, v=v, h=h, **conv)),
        "qmatmul": (qmatmul_ops.qmatmul_op, qargs, lambda: qmatmul_ops.qmatmul_ref(*qargs)),
    }


@pytest.mark.parametrize("name", ["msca_fused", "parallel_cascade", "lowrank_conv", "qmatmul"])
def test_custom_ops_take_bf16_on_the_cpu_and_in_their_fake_kernels(name):
    op, args, plain = op_cases()[name]
    y = op(*args)
    assert y.dtype == torch.bfloat16 and torch.equal(y, plain())
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    assert fake.dtype == torch.bfloat16 and tuple(fake.shape) == tuple(y.shape)
