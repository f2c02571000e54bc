"""The port's native batch prep (``data/native.py``, ``data/_native/batch_prep.cpp``)
against the JAX package's library and against numpy.

* ``prep_batch`` / ``prep_batch_aug`` (float32, normalized on the host) bit for
  bit equal to the JAX library's (``convnet_approximater_tpu.data.native``,
  built here by g++ from its own source) on the same pool, indices and
  ``draw_aug_params`` draws, and within 1e-6 of numpy's ``(x - mean) / std``
  (the JAX tests' tolerance for its library, ``tests/test_data.py``).
* The uint8 entries equal the numpy gather, resize and ``apply_aug``.
* The ``Loader``'s batches with and without the native gather are equal, and
  within 1e-6 of the JAX ``Loader``'s; ``serve``'s ``HostNormLoader`` the same.
* A library that cannot be built raises (no silent numpy fallback); bad
  inputs raise before the library is called.

The library runs at one or two threads here.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from convnet_approximater_tpu import data as jdata  # noqa: E402
from convnet_approximater_tpu.data import native as jnative  # noqa: E402
from convnet_approximater_tpu_torch import data as tdata  # noqa: E402
from convnet_approximater_tpu_torch.data import native  # noqa: E402
from convnet_approximater_tpu_torch.data.loader import (_resize_nearest, apply_aug,  # noqa: E402
                                                        draw_aug_params)
from convnet_approximater_tpu_torch.serve import HostNormLoader  # noqa: E402

torch.set_num_threads(1)
NORM_TOL = 1e-6
MEAN255 = np.asarray([0.485, 0.456, 0.406], np.float32) * 255.0
STD255 = np.asarray([0.229, 0.224, 0.225], np.float32) * 255.0
AUGS = {"none": None, "crop_pad": dict(crop_pad=3),
        "hflip_crop_pad": dict(hflip=0.7, crop_pad=3),
        "rrc_scale": dict(rrc_scale=(0.3, 1.0), hflip=0.5), "hflip_all": dict(hflip=1.0)}


def pool_and_indices(seed=0, n=24, hw=(14, 18)):
    rs = np.random.RandomState(seed)
    pool = rs.randint(0, 256, (n,) + hw + (3,), dtype=np.uint8)
    return pool, rs.permutation(n)[:9].astype(np.int64)


def bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("out_hw", [(14, 18), (8, 8), (20, 24)])
@pytest.mark.parametrize("aug", sorted(AUGS))
def test_float32_entries_bit_equal_to_jax_library(aug, out_hw):
    pool, idx = pool_and_indices()
    if AUGS[aug] is None:
        want = jnative.prep_batch(pool, idx, out_hw, MEAN255, STD255, num_threads=2)
        got = native.prep_batch(pool, idx, out_hw, MEAN255, STD255, num_threads=2)
        ref = _resize_nearest(pool[idx], out_hw)
    else:
        params = draw_aug_params(np.random.RandomState(42), len(idx), 14, 18, **AUGS[aug])
        want = jnative.prep_batch_aug(pool, idx, out_hw, MEAN255, STD255, params, num_threads=2)
        got = native.prep_batch_aug(pool, idx, out_hw, MEAN255, STD255, params, num_threads=2)
        ref = apply_aug(pool[idx], params, out_hw)
    assert want is not None  # the JAX library built and ran (else it gives way to numpy)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(bits(got), bits(want))
    np.testing.assert_allclose(got, (ref.astype(np.float32) - MEAN255) / STD255, rtol=0,
                               atol=NORM_TOL)


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("aug", sorted(AUGS))
def test_uint8_entries_equal_the_numpy_gather(aug, threads):
    pool, idx = pool_and_indices(1)
    for out_hw in ((14, 18), (7, 11), (21, 30)):
        if AUGS[aug] is None:
            got = native.gather_batch(pool, idx, out_hw, num_threads=threads)
            want = _resize_nearest(pool[idx], out_hw)
        else:
            params = draw_aug_params(np.random.RandomState(3), len(idx), 14, 18, **AUGS[aug])
            got = native.gather_batch_aug(pool, idx, out_hw, params, num_threads=threads)
            want = apply_aug(pool[idx], params, out_hw)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    out = np.zeros((len(idx), 14, 18, 3), np.uint8)  # into a caller's buffer
    assert native.gather_batch(pool, idx, (14, 18), out=out) is out
    assert np.array_equal(out, pool[idx])


LOADER_CASES = {
    "plain": dict(),
    "resized": dict(image_size=(16, 20)),
    "crop_pad": dict(aug=dict(crop_pad=3, hflip=0.5)),
    "rrc_scale": dict(image_size=(14, 14), aug=dict(rrc_scale=(0.3, 1.0), hflip=0.5)),
    "rand_aug": dict(aug=dict(rand_aug=dict(n=2, m=9), hflip=0.5)),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_native_equals_numpy_and_jax(case):
    kw = dict(LOADER_CASES[case], shuffle=True, mean=tuple(MEAN255 / 255), std=tuple(STD255 / 255),
              seed=5)
    ds = tdata.Synthetic(32, (12, 13, 3), 4, seed=2)
    jl = jdata.Loader(jdata.Synthetic(32, (12, 13, 3), 4, seed=2), 8, prefetch=0, **kw)
    loaders = [tdata.Loader(ds, 8, device="cpu", native=n, **kw) for n in (True, False)]
    for epoch in (0, 1):
        for loader in loaders + [jl]:
            loader.set_epoch(epoch)
        order = loaders[0]._indices()
        nat, ref = (list(loader) for loader in loaders)
        for i, ((x, y), (xr, yr), (jx, jy)) in enumerate(zip(nat, ref, jl)):
            idx = order[i * 8:(i + 1) * 8]
            assert np.array_equal(loaders[0].gather(idx)[0], loaders[1].gather(idx)[0])
            assert torch.equal(x, xr) and torch.equal(y, yr)
            np.testing.assert_allclose(x.permute(0, 2, 3, 1).numpy(), np.asarray(jx),
                                       rtol=NORM_TOL, atol=NORM_TOL)
            assert np.array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("aug", [None, dict(crop_pad=2, hflip=0.5)])
def test_host_norm_loader_normalizes_through_the_library(aug):
    mean, std = tuple(MEAN255 / 255), tuple(STD255 / 255)
    ds = tdata.Synthetic(24, (10, 12, 3), 4, seed=1)
    nat, ref = (HostNormLoader(ds, 8, shuffle=True, mean=mean, std=std, seed=3, device="cpu",
                               aug=aug, native=n) for n in (True, False))
    idx = nat._indices()[:8]
    x, _ = nat._prep(idx)
    xr, _ = ref._prep(idx)
    np.testing.assert_allclose(x.numpy(), xr.numpy(), rtol=0, atol=NORM_TOL)
    out_hw, params, _ = nat.geometry(idx)
    want = (jnative.prep_batch(ds.images, idx, out_hw, nat.mean, nat.std) if params is None
            else jnative.prep_batch_aug(ds.images, idx, out_hw, nat.mean, nat.std, params))
    assert np.array_equal(bits(x.numpy()), bits(want))
    for (a, la), (b, lb) in zip(nat, ref):
        assert a.dtype == torch.float32 and torch.equal(la, lb)
        assert float((a - b).abs().max()) <= NORM_TOL


def test_a_library_that_cannot_be_built_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    with pytest.raises(RuntimeError, match="cannot run no-such-compiler"):
        native.build()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert not list((tmp_path / "native").glob("*.so"))


def test_bad_inputs_raise_before_the_call():
    pool, idx = pool_and_indices()
    with pytest.raises(TypeError, match="uint8"):
        native.gather_batch(pool.astype(np.float32), idx, (4, 4))
    with pytest.raises(IndexError, match="outside the pool"):
        native.gather_batch(pool, np.array([0, len(pool)]), (4, 4))
    with pytest.raises(ValueError, match="out must be"):
        native.gather_batch(pool, idx, (4, 4), out=np.empty((len(idx), 4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="shape"):
        native.gather_batch_aug(pool, idx, (4, 4), draw_aug_params(
            np.random.RandomState(0), len(idx) + 1, 14, 18, hflip=0.5))
    with pytest.raises(TypeError, match="uint8"):
        tdata.Loader(tdata.ArrayDataset(pool.astype(np.float32), np.zeros(len(pool), np.int64)),
                     4, device="cpu").gather(idx[:4])
    assert native.gather_batch(pool, idx[:0], (4, 4)).shape == (0, 4, 4, 3)
