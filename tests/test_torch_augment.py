"""The port's RandAugment and Mixup/CutMix against the JAX package's.

* Each RandAugment op, ``rand_augment_batch`` and the ``Loader`` with
  ``aug=dict(rand_aug=...)`` (alone and before the crop and flip draws): the
  same bytes as the JAX package's (``np.array_equal``), the normalised batches
  too.
* Mixup and CutMix with the draws injected (the JAX package's permutation,
  lambda and box centre given to the port): within 1e-6.  ``lam = 1`` is the
  identity, both alphas 0 pass the batch through and draw nothing, CutMix's
  target lambda is the fraction of pixels kept, and the draws follow the
  configured modes.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu import data as jdata  # noqa: E402
from convnet_approximater_tpu.data import loader as jloader  # noqa: E402
from convnet_approximater_tpu.data import mixup as jmixup  # noqa: E402
from convnet_approximater_tpu.data import randaug as jrandaug  # noqa: E402
from convnet_approximater_tpu_torch import data as tdata  # noqa: E402
from convnet_approximater_tpu_torch.data import mixup as tmixup  # noqa: E402
from convnet_approximater_tpu_torch.data import randaug as trandaug  # noqa: E402

torch.set_num_threads(1)
MIX_TOL = 1e-6
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def pool(n=6, h=13, w=11, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("m", [0.0, 5.0, 9.0, 10.0])
def test_rand_aug_ops_match_jax(m):
    imgs = pool()
    assert [n for n, _ in trandaug.RAND_AUG_OPS] == [n for n, _ in jrandaug.RAND_AUG_OPS]
    for (name, top), (_, jop) in zip(trandaug.RAND_AUG_OPS, jrandaug.RAND_AUG_OPS):
        for img in imgs[:3]:
            a, b = jop(img, m, np.random.RandomState(3)), top(img, m, np.random.RandomState(3))
            assert b.dtype == np.uint8 and b.shape == img.shape, name
            np.testing.assert_array_equal(b, a, err_msg=name)
    # a flat channel (Equalize's and AutoContrast's special cases)
    flat = np.full((8, 8, 3), 77, np.uint8)
    for (name, top), (_, jop) in zip(trandaug.RAND_AUG_OPS, jrandaug.RAND_AUG_OPS):
        np.testing.assert_array_equal(top(flat, m, np.random.RandomState(1)),
                                      jop(flat, m, np.random.RandomState(1)), err_msg=name)


def test_rand_augment_batch_and_augment_batch_match_jax():
    imgs = pool(8)
    for n, m in ((0, 9), (1, 4), (2, 9), (3, 10)):
        a = jrandaug.rand_augment_batch(imgs, np.random.RandomState(5), n=n, m=m)
        b = trandaug.rand_augment_batch(imgs, np.random.RandomState(5), n=n, m=m)
        np.testing.assert_array_equal(b, a)
    kw = dict(rand_aug=dict(n=2, m=9), hflip=0.5, crop_pad=2)
    np.testing.assert_array_equal(tdata.augment_batch(imgs, np.random.RandomState(2), **kw),
                                  jloader.augment_batch(imgs, np.random.RandomState(2), **kw))


@pytest.mark.parametrize("aug", [
    dict(rand_aug=dict(n=2, m=9)),
    dict(rand_aug=dict(n=1, m=5), hflip=0.5, crop_pad=2),
    dict(rand_aug=dict(n=2, m=7), rrc_scale=(0.4, 1.0), hflip=0.5),
])
def test_loader_with_rand_aug_matches_jax(aug):
    kw = dict(shuffle=True, mean=MEAN, std=STD, seed=3, aug=aug,
              image_size=(10, 10) if "rrc_scale" in aug else None)
    jl = jdata.Loader(jdata.Synthetic(24, (12, 13, 3), 4, seed=1), 8, prefetch=0, **kw)
    tl = tdata.Loader(tdata.Synthetic(24, (12, 13, 3), 4, seed=1), 8, device="cpu", **kw)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        order = tl._indices()
        for i, ((jx, jy), (tx, ty)) in enumerate(zip(jl, tl)):
            idx = order[i * 8:(i + 1) * 8]
            # the uint8 batch the JAX loader's route normalises, drawn from its seed
            rs = np.random.RandomState((3 * 1000003 + epoch * 9176 + int(idx[0])) % 2 ** 31)
            ref = jrandaug.rand_augment_batch(jl.dataset.images[idx], rs, **aug["rand_aug"])
            rest = {k: v for k, v in aug.items() if k != "rand_aug"}
            ref = jloader.apply_aug(ref, jloader.draw_aug_params(rs, 8, 12, 13, **rest),
                                    kw["image_size"] or (12, 13))
            u8, _ = tl.gather(idx)
            np.testing.assert_array_equal(u8, ref)
            assert np.array_equal(tx.permute(0, 2, 3, 1).numpy(), np.asarray(jx))
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def batch(b=6, h=9, w=7, c=3, k=5, seed=0):
    """An NHWC image batch and smoothed one-hot targets, as numpy."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((b, h, w, c)).astype(np.float32)
    t = np.eye(k, dtype=np.float32)[rs.randint(0, k, b)] * 0.9 + 0.1 / k
    return x, t


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("lam", [1.0, 0.7, 0.25, 0.0])
def test_mixup_matches_jax_with_injected_draws(lam):
    x, t = batch()
    rng = jax.random.key(11)
    jx, jt = jmixup.mixup_batch(rng, jnp.asarray(x), jnp.asarray(t), lam)
    perm = torch.from_numpy(np.array(jax.random.permutation(rng, x.shape[0])))
    tx, tt = tmixup.mixup_batch(nchw(x), torch.from_numpy(t), lam, perm)
    np.testing.assert_allclose(tx.permute(0, 2, 3, 1).numpy(), np.asarray(jx), rtol=0,
                               atol=MIX_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=MIX_TOL)
    if lam == 1.0:  # the identity
        assert torch.equal(tx, nchw(x)) and torch.equal(tt, torch.from_numpy(t))
    # bf16 images mix in bf16 with lambda rounded to bf16, as the JAX package casts it
    jb, _ = jmixup.mixup_batch(rng, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t), lam)
    tb, _ = tmixup.mixup_batch(nchw(x).to(torch.bfloat16), torch.from_numpy(t), lam, perm)
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jb.astype(jnp.float32)))


@pytest.mark.parametrize("lam,key", [(0.7, 0), (0.3, 1), (0.05, 2), (0.99, 3), (0.0, 4)])
def test_cutmix_matches_jax_with_injected_draws(lam, key):
    x, t = batch(h=12, w=10, seed=key)
    rng = jax.random.key(key)
    jx, jt = jmixup.cutmix_batch(rng, jnp.asarray(x), jnp.asarray(t), jnp.float32(lam))
    k_perm, k_cy, k_cx = jax.random.split(rng, 3)
    perm = torch.from_numpy(np.array(jax.random.permutation(k_perm, x.shape[0])))
    cy, cx = int(jax.random.randint(k_cy, (), 0, 12)), int(jax.random.randint(k_cx, (), 0, 10))
    tx, tt = tmixup.cutmix_batch(nchw(x), torch.from_numpy(t), lam, perm, cy, cx)
    np.testing.assert_allclose(tx.permute(0, 2, 3, 1).numpy(), np.asarray(jx), rtol=0,
                               atol=MIX_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=MIX_TOL)
    # the target lambda is the fraction of each image's pixels kept
    kept = (tx == nchw(x)).all(dim=1).float().mean(dim=(1, 2))
    y0, y1, x0, x1, lam_actual = tmixup.cutmix_box(12, 10, lam, cy, cx)
    moved = perm != torch.arange(len(perm))
    assert torch.allclose(kept[moved], torch.full_like(kept[moved], lam_actual), atol=1e-6)
    want_t = lam_actual * torch.from_numpy(t) + (1 - lam_actual) * torch.from_numpy(t)[perm]
    assert torch.allclose(tt, want_t, atol=MIX_TOL)


def test_mix_draws_follow_the_modes():
    x, t = batch()
    images, targets = nchw(x), torch.from_numpy(t)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    out = tmixup.mixup_cutmix(gen, images, targets)  # both off: passed through, nothing drawn
    assert out[0] is images and out[1] is targets and torch.equal(gen.get_state(), state)
    draws = [tmixup.draw_mix(gen, 6, 9, 7, mixup_alpha=0.8) for _ in range(5)]
    assert not any(d.cutmix for d in draws)
    draws = [tmixup.draw_mix(gen, 6, 9, 7, cutmix_alpha=1.0) for _ in range(5)]
    assert all(d.cutmix and 0 <= d.cy < 9 and 0 <= d.cx < 7 for d in draws)
    draws = [tmixup.draw_mix(gen, 6, 9, 7, 0.8, 1.0, switch_prob=0.5) for _ in range(200)]
    share = np.mean([d.cutmix for d in draws])
    assert 0.35 < share < 0.65
    for d in draws:
        assert 0.0 <= d.lam <= 1.0 and sorted(d.perm.tolist()) == list(range(6))
    # the same seed draws the same mix
    a = tmixup.draw_mix(torch.Generator().manual_seed(4), 6, 9, 7, 0.8, 1.0)
    b = tmixup.draw_mix(torch.Generator().manual_seed(4), 6, 9, 7, 0.8, 1.0)
    assert a.cutmix == b.cutmix and a.lam == b.lam and torch.equal(a.perm, b.perm)
