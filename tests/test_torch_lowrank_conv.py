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


# -- the CUDA kernel's layout and planner, checked on the CPU ------------------------------

ALEX_SHAPES = [  # AlexNet's convs 2-5 at b=64, 224^2: x (B, H, W, C), M, N, k, padding
    ((64, 27, 27, 64), 8, 192, 5, 2), ((64, 13, 13, 192), 8, 384, 3, 1),
    ((64, 13, 13, 384), 6, 256, 3, 1), ((64, 13, 13, 256), 4, 256, 3, 1)]
RAGGED = [  # x, M, N, (kh, kw), stride, padding: every tile of P ragged, C = 6, N = 10, ...
    ((2, 13, 13, 6), 4, 10, (5, 5), (2, 2), (2, 2)),   # stride 2, tiles straddle images
    ((1, 9, 11, 6), 4, 10, (3, 3), (1, 1), (1, 1)),    # H != W
    ((3, 10, 7, 9), 3, 17, (3, 5), (1, 2), (1, 2)),    # kh != kw, odd M, mixed stride
    ((2, 6, 5, 20), 10, 40, (3, 3), (1, 1), (1, 1)),   # two slabs of bases, 30 pixels an image
    ((1, 40, 40, 8), 2, 200, (1, 1), (1, 1), (0, 0)),  # a 1 x 1 basis, N over two tiles
]


def _plan_cases():
    cases = [(x, M, N, (k, k), (1, 1), (p, p)) for x, M, N, k, p in ALEX_SHAPES]
    return cases + RAGGED


def _weights(M, C, N, kernel_size, form, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    kh, kw = kernel_size
    taps = dict(v=r(M, kh), h=r(M, kw)) if form == "sep" else dict(bases=r(M, kh, kw))
    return r(M * C, N) * (M * C) ** -0.5, r(N) * 0.1, taps


def emulate_kernel(x, b, packed, kernel_size, stride, padding, M, N):
    """The CUDA kernel's dataflow in torch: per tile of BM pixels, the x window
    (rows of x's stack of B H rows from the tile's first pixel's first tap row,
    columns from -pw, zero outside x), each pixel's taps read at its window
    cell or, for a tap row in its image's vertical padding, as zeros; Z in the
    kernel's K' order (lowrank_ops.kernel_order), then the 3xTF32 product with
    the packed weight and the bias.  Asserts that the window holds every tap."""
    B, H, W, C = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    p = lowrank_ops.plan(B, H, W, C, M, N, kernel_size, stride, padding)
    Ho, Wo = lowrank_ops.out_size(H, W, kernel_size, stride, padding)
    P = B * Ho * Wo
    quads = -(-C // 4)
    xs = torch.nn.functional.pad(x, (0, 4 * quads - C)).reshape(B * H, W, 4 * quads)
    c_of, m_of = lowrank_ops.kernel_order(C, M)
    taps = packed["taps"]  # (kh kw, Mp)
    y = torch.empty(P, N, dtype=torch.float64)
    i, j = torch.arange(kh).repeat_interleave(kw), torch.arange(kw).repeat(kh)
    for t in range(p.row_tiles):
        rows = torch.arange(t * lowrank_ops.BM, (t + 1) * lowrank_ops.BM)
        pix = rows.clamp(max=P - 1)
        vbase = int(lowrank_ops.window_row(pix[:1], Ho, Wo, H, sh, ph))
        v = vbase + torch.arange(p.rw)
        col = torch.arange(p.wv) - pw
        ok = ((v >= 0) & (v < B * H))[:, None] & ((col >= 0) & (col < W))[None, :]
        window = torch.where(ok[..., None], xs[v.clamp(0, B * H - 1)[:, None],
                                                col.clamp(0, W - 1)[None, :]], 0.0)
        vrow = lowrank_ops.window_row(pix, Ho, Wo, H, sh, ph) - vbase
        vcol = (pix % (Ho * Wo)) % Wo * sw
        assert int(vrow.min()) >= 0 and int(vrow.max()) + kh <= p.rw  # every tap in the window
        assert int(vcol.max()) + kw <= p.wv
        h0 = (pix % (Ho * Wo)) // Wo * sh - ph
        in_image = ((h0[:, None] + i[None]) >= 0) & ((h0[:, None] + i[None]) < H)
        xt = window[vrow[:, None] + i[None], vcol[:, None] + j[None]]  # (BM, kh kw, 4 quads)
        xt = torch.where(in_image[..., None], xt, 0.0)
        z = torch.einsum("ptc,tm->pcm", xt, taps)  # (BM, C', Mp): float32 sums
        zk = z[:, c_of, m_of]  # the K' columns, zero where c >= C or m >= M
        zh = lowrank_ops.tf32_round(zk)
        zl = zk - zh  # the kernel's low part: wgmma reads its top 19 bits
        wh, wl = packed["w"].double()
        acc = zl.double() @ wh.t() + zh.double() @ wl.t() + zh.double() @ wh.t()
        keep = rows < P
        y[rows[keep]] = acc[keep] + b.double()
    return y.float().reshape(B, Ho, Wo, N)


@pytest.mark.parametrize("case", range(len(ALEX_SHAPES) + len(RAGGED)))
def test_plan_tiles_cover_every_output_once(case):
    (B, H, W, C), M, N, ks, st, pad = _plan_cases()[case]
    p = lowrank_ops.plan(B, H, W, C, M, N, ks, st, pad)
    Ho, Wo = lowrank_ops.out_size(H, W, ks, st, pad)
    P = B * Ho * Wo
    count = torch.zeros(P, N, dtype=torch.int32)
    for rt in range(p.row_tiles):  # a block writes its rows < P and columns < N
        for ct in range(p.col_tiles):
            count[rt * lowrank_ops.BM:min(P, (rt + 1) * lowrank_ops.BM),
                  ct * p.bn:min(N, (ct + 1) * p.bn)] += 1
    assert bool((count == 1).all())
    assert p.bn in lowrank_ops.BNS and (p.ms, p.slabs) == lowrank_ops.basis_slabs(M)
    assert p.ms * p.slabs >= M and p.ms in lowrank_ops.SLABS and p.stages in (2, 3, 4)


@pytest.mark.parametrize("case", range(len(ALEX_SHAPES) + len(RAGGED)))
def test_plan_window_holds_every_tap(case):
    """Each tile's window (rw rows of x's stack of B H rows from the tile's
    first pixel's first tap row) holds every tap row of every pixel of the
    tile that lies in the pixel's image, across image boundaries, at the right
    row of x; the others are the image's vertical padding."""
    (B, H, W, C), M, N, (kh, kw), (sh, sw), (ph, pw) = _plan_cases()[case]
    p = lowrank_ops.plan(B, H, W, C, M, N, (kh, kw), (sh, sw), (ph, pw))
    Ho, Wo = lowrank_ops.out_size(H, W, (kh, kw), (sh, sw), (ph, pw))
    P = B * Ho * Wo
    pix = torch.arange(P)
    first = (pix // lowrank_ops.BM) * lowrank_ops.BM
    base = lowrank_ops.window_row(first, Ho, Wo, H, sh, ph)
    vrow = lowrank_ops.window_row(pix, Ho, Wo, H, sh, ph) - base
    assert int(vrow.min()) >= 0 and int((vrow + kh).max()) <= p.rw
    b, ho, wo = pix // (Ho * Wo), (pix % (Ho * Wo)) // Wo, pix % Wo
    for i in range(kh):  # window row vrow + i is row ho sh - ph + i of image b where that is in it
        hin = ho * sh - ph + i
        inside = (hin >= 0) & (hin < H)
        assert torch.equal((base + vrow + i)[inside], (b * H + hin)[inside])
    assert int((wo * sw + kw).max()) <= p.wv == (Wo - 1) * sw + kw
    if B > 1 and Ho * Wo % lowrank_ops.BM:  # some tile then crosses an image boundary
        assert bool((b[first] != b[torch.clamp(first + lowrank_ops.BM, max=P) - 1]).any())


@pytest.mark.parametrize("case", range(len(ALEX_SHAPES) + len(RAGGED)))
def test_plan_shared_memory_fits(case):
    (B, H, W, C), M, N, ks, st, pad = _plan_cases()[case]
    p = lowrank_ops.plan(B, H, W, C, M, N, ks, st, pad)
    assert p.smem == lowrank_ops.smem_bytes(p.ms, p.bn, p.stages, p.qpg, p.rw, p.wv,
                                            ks[0] * ks[1], p.ms * p.slabs)
    assert p.smem <= lowrank_ops.SMEM_MAX
    assert p.stages * lowrank_ops.stage_bytes(p.ms, p.bn) >= lowrank_ops.STAGE_BYTES  # epilogue


@pytest.mark.parametrize("form", ["sep", "full"])
@pytest.mark.parametrize("M,C", [(8, 64), (6, 7), (3, 5), (10, 4)])
def test_packed_layout_reconstructs_A(form, M, C):
    N = 13
    A, _, taps = _weights(M, C, N, (3, 5), form)
    packed = lowrank_ops.pack_kernel_weights(A, **taps)
    w = packed["w"]
    ms, slabs = lowrank_ops.basis_slabs(M)
    Kp = 4 * -(-C // 4) * ms * slabs
    assert w.shape == (2, N, Kp) and w.is_contiguous()
    for part in w:  # both parts are TF32: 13 low mantissa bits zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    c, m = lowrank_ops.kernel_order(C, M)
    valid = (c < C) & (m < M)
    assert sorted((m[valid] * C + c[valid]).tolist()) == list(range(M * C))  # each row once
    rebuilt = torch.zeros(M * C, N, dtype=torch.float64)
    rebuilt[m[valid] * C + c[valid]] = (w[0] + w[1]).double().t()[valid]
    assert float((rebuilt - A.double()).abs().max()) <= 2 ** -21 * float(A.abs().max())
    assert bool((w[:, :, ~valid] == 0).all())  # the padding is zero
    basis = taps["bases"] if form == "full" else taps["v"][:, :, None] * taps["h"][:, None, :]
    assert torch.equal(packed["taps"][:, :M], basis.reshape(M, 15).t())
    assert bool((packed["taps"][:, M:] == 0).all())


def test_tf32_round_is_round_to_nearest_away():
    ulp = 2.0 ** -10  # TF32's ulp at 1.0
    x = torch.tensor([1.0 + ulp / 2, 1.0 + ulp / 2 - 2 ** -23, -(1.0 + ulp / 2), 1.0 + ulp * 1.5,
                      float("inf"), 3.0e38])
    r = lowrank_ops.tf32_round(x)
    assert r[:4].tolist() == [1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp]  # ties away from 0
    assert r[4] == float("inf") and bool(torch.isfinite(r[5]))


def test_3xtf32_product_keeps_float32_accuracy():
    """The kernel's mix, Z_lo A_hi + Z_hi A_lo + Z_hi A_hi on TF32 parts, is
    within 1e-6 relative of the exact product at conv4's K = 6 x 384 = 2304
    (one TF32 product alone is not: about 1e-4)."""
    g = np.random.RandomState(7)
    z = torch.from_numpy(g.randn(256, 2304).astype(np.float32))
    a = torch.from_numpy((g.randn(2304, 64) / 48).astype(np.float32))
    exact = z.double() @ a.double()
    zh, ah = lowrank_ops.tf32_round(z), lowrank_ops.tf32_round(a)
    zl, al = lowrank_ops.tf32_round(z - zh), lowrank_ops.tf32_round(a - ah)
    three = zl @ ah + zh @ al + zh @ ah  # float32 sums, as the tensor cores accumulate
    assert rel(three.double().numpy(), exact.numpy()) < 1e-6
    assert rel((zh @ ah).double().numpy(), exact.numpy()) > 1e-5


@pytest.mark.parametrize("form", ["sep", "full"])
@pytest.mark.parametrize("case", range(len(RAGGED)))
def test_kernel_emulation_matches_ref(form, case):
    """The kernel's index arithmetic (tiles across image boundaries, the
    window, the K' order, the padding of C, M and N) in torch, against
    lowrank_conv_ref: 1e-5 relative, the kernel's gate on the card."""
    (B, H, W, C), M, N, ks, st, pad = RAGGED[case]
    A, b, taps = _weights(M, C, N, ks, form, seed=case)
    x = torch.from_numpy(nhwc(B, H, W, C, seed=case))
    packed = lowrank_ops.pack_kernel_weights(A, **taps)
    y = emulate_kernel(x, b, packed, ks, st, pad, M, N)
    y_ref = lowrank_ops.lowrank_conv_ref(x, A, b, kernel_size=ks, stride=st, padding=pad, **taps)
    assert y.shape == y_ref.shape
    assert rel(y.numpy(), y_ref.numpy()) < RTOL


@pytest.mark.parametrize("case,bn", [(0, 96), (1, 128), (2, 96), (3, 96)])
def test_plan_picks_the_measured_tiles(case, bn):
    """At AlexNet's convs 2-5 the planner picks the output tile that
    ops/lowrank_conv_sweep.py measured fastest on an H100 (PERF.md)."""
    (B, H, W, C), M, N, ks, st, pad = _plan_cases()[case]
    assert lowrank_ops.plan(B, H, W, C, M, N, ks, st, pad).bn == bn
