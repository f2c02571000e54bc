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


# -- the kernel's plan (ops/msca_fused.py::plan), checked here where no card is present ----

# MSCAN-t's eight block shapes at b=64, 224^2 (both forms), then ragged ones, the last ones on
# march_any_kernel (k0 other than 5, k_max other than 21): (B, H, W, C, k0, ks)
PLAN_CASES = [(64, H, H, Cs, 5, ks) for H, Cs in ((56, 32), (28, 64), (14, 160), (7, 256))
              for ks in ((7, 11, 21), (21,))]
PLAN_CASES += [(4, 20, 37, 32, 5, (21,)), (4, 12, 12, 40, 5, (7, 11, 21)), (4, 6, 9, 32, 5, (21,)),
               (1, 9, 70, 40, 5, (21,)), (4, 16, 17, 32, 3, (9, 13)), (2, 12, 20, 40, 7, (33, 45)),
               (2, 9, 20, 32, 5, (127,)), (1, 9, 200, 32, 3, (127,)),
               (2, 10, 11, 40, 5, (3, 5, 7, 9, 11, 13, 15, 15)), (2, 12, 12, 32, 31, (7,))]


def _check_tiles(p, B, H, W, Cs, k0, ks):
    """Shared memory within 227 KB, at most two launches, a halo of at least
    k0/2 + k_max/2 rows, and the march's grid (decoded as the kernel's
    tile_of does: band fastest, then column tile, channel chunk, image) covering
    every (image, row, column, channel) exactly once."""
    assert p is not None
    assert p.smem <= 232_448 and p.smem == fused_ops.smem_bytes(p.K, k0, len(ks), p.g, p.warps,
                                                                p.tw)
    assert p.launches <= 2
    assert p.K >= max(ks) and p.halo >= k0 // 2 + max(ks) // 2
    assert p.warps <= fused_ops.MAX_WARPS and (p.g == 1 or p.tw <= p.warps * p.g)
    assert p.blocks == B * p.nchunks * p.ntiles * p.bands
    count = np.zeros((B, H, W, Cs), np.int8)
    for blk in range(p.blocks):
        band, rest = blk % p.bands, blk // p.bands
        tile, rest = rest % p.ntiles, rest // p.ntiles
        chunk, image = rest % p.nchunks, rest // p.nchunks
        count[image, band * p.rows:(band + 1) * p.rows, tile * p.tw:(tile + 1) * p.tw,
              chunk * 32:(chunk + 1) * 32] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plan_tiles_every_output_once(case):
    """The planner's choice at each shape: see _check_tiles; MSCAN-t's blocks
    (k0 = 5, k_max = 21) take march_kernel, every other block march_any_kernel."""
    B, H, W, Cs, k0, ks = case
    p = fused_ops.plan(B, H, W, Cs, k0, ks)
    _check_tiles(p, B, H, W, Cs, k0, ks)
    assert (p.g == fused_ops.FAST_G) == (k0 == 5 and max(ks) == 21)


@pytest.mark.parametrize("fast", [True, False], ids=["march", "march_any"])
@pytest.mark.parametrize("bands", [2, 3])
def test_plan_tiles_every_output_once_in_bands(fast, bands):
    """Either kernel's tiles at more than one band (the sweep's plans)."""
    B, H, W, Cs, k0, ks = 2, 20, 70, 40, 5, (21,)
    p = fused_ops._tiles(B, H, W, Cs, k0, ks, fast, bands)
    assert p.bands == bands
    _check_tiles(p, B, H, W, Cs, k0, ks)


def _banded_ref(args, ks, identity, fix_p, p):
    """msca_fused_ref on each band and column tile of plan ``p`` cut out with its
    halo, the border fix added at the true map's top and bottom rows only."""
    x, w0, b0, w1, b1, w2, b2, wm, bm, res = args
    B, H, W, Cs = x.shape
    strip = fused_ops.fix_strip(res, H) if fix_p else torch.zeros(H, Cs)
    out = torch.full_like(x, float("nan"))
    for h0 in range(0, H, p.rows):
        for w0_ in range(0, W, p.tw):
            r0, c0 = max(0, h0 - p.halo), max(0, w0_ - p.halo)
            window = x[:, r0:min(H, h0 + p.rows + p.halo), c0:min(W, w0_ + p.tw + p.halo)]
            y = fused_ops.msca_fused_ref(window.contiguous(), w0, b0, w1, b1, w2, b2, wm, bm,
                                         ks=ks, identity=identity, fix_p=0)
            rows, cols = slice(h0 - r0, h0 - r0 + p.rows), slice(w0_ - c0, w0_ - c0 + p.tw)
            fix = (strip[h0:h0 + p.rows] @ wm)[None, :, None, :]  # the fix through the mix
            out[:, h0:h0 + p.rows, w0_:w0_ + p.tw] = (
                y[:, rows, cols] + x[:, h0:h0 + p.rows, w0_:w0_ + p.tw] * fix)
    return out


@pytest.mark.parametrize("H,W,k0,ks,identity,fix_p,bands", [
    (20, 70, 5, (21,), False, 10, 3),          # d1+fix: three bands, three column tiles
    (23, 9, 3, (7, 11, 21), True, 0, 4),       # the dense bank, four bands
    (7, 40, 5, (21,), False, 10, 2),           # fix_p > H / 2: both strips on every row
])
def test_plan_halo_reassembles_the_whole_map(H, W, k0, ks, identity, fix_p, bands):
    """The plan's bands and column tiles, each run with its halo as a map of its
    own, give the whole map's result: the halo arithmetic the kernel relies on."""
    g = torch.Generator().manual_seed(11)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    w1, b1, w2, b2, ks = fused_ops.pack_cascade_weights(
        [r(k, C) / k for k in ks], [r(C) for _ in ks], [r(k, C) / k for k in ks],
        [r(C) for _ in ks])
    args = [r(2, H, W, C), r(k0, k0, C) / k0, r(C), w1, b1, w2, b2, r(C, C) / C ** 0.5, r(C),
            r(2, fix_p, C) if fix_p else None]
    p = fused_ops._tiles(2, H, W, C, k0, ks, k0 == 5 and max(ks) == 21, bands)
    assert p.bands == bands and p.ntiles * p.tw >= W
    y = _banded_ref(args, ks, identity, fix_p, p)
    y_ref = fused_ops.msca_fused_ref(*args, ks=ks, identity=identity, fix_p=fix_p)
    assert rel(y.numpy(), y_ref.numpy()) < 1e-6


def test_plan_takes_every_fusable_block():
    """Every bank that ``packed()`` admits (nb <= 8, nb k_max <= 128) with any odd
    conv0 gets a plan, so an eval-mode MSCA block with such a conv0 fuses."""
    for k0 in (1, 3, 5, 7, 31):
        for ks in ((21,), (7, 11, 21), (127,), (15,) * 8, (3, 61), (1,)):
            _check_tiles(fused_ops.plan(1, 9, 40, 40, k0, ks), 1, 9, 40, 40, k0, ks)
    m = MSCA(C, 31, (7,)).eval()
    with torch.no_grad():
        assert m.can_fuse()


@pytest.mark.parametrize("edit", ["conv0", "channel_mix", "res"])
def test_fused_forward_follows_in_place_weight_edits(edit):
    """The kernel's weight layouts are cached per weight version: after an
    in-place edit of the conv0, mix or border weights of an eval-mode d1+fix
    MSCA block, the fused forward gives the module path's new output."""
    torch.manual_seed(0)
    m = MscaRep(decomp=1, fix=True).initialize(MSCA(C, 5, (7, 11, 21))).new_module.eval()
    x = torch.from_numpy(nhwc(9, 11)).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert m.can_fuse()
        y0 = m(x)
        cached = m._kernel_weights()
        assert m._kernel_weights() is cached  # no edit: the same layouts
        param = {"conv0": m.conv0.weight, "channel_mix": m.channel_mix.weight,
                 "res": m.sd_convs[1].res}[edit]
        param.mul_(1.5).add_(0.1)
        y1 = m(x)
        assert m._kernel_weights() is not cached
        m.train()
        y_module = m(x)
    assert rel(y1.numpy(), y_module.numpy()) < RTOL
    assert rel(y1.numpy(), y0.numpy()) > 1e-3
