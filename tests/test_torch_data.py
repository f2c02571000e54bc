"""The port's data pipeline against the JAX package's.

``Synthetic`` must draw the same bytes; the port's ``Loader`` must gather the
same uint8 batches (in the same shuffle order, resized, and with the hflip,
crop_pad and rrc_scale augmentations drawn from the same seeds) bit for bit,
and normalise them to within 1e-6 of the JAX loader's float32 batches (which
may come from its C++ batch prep, whose arithmetic order differs).
"""

import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from convnet_approximater_tpu import data as jdata  # noqa: E402
from convnet_approximater_tpu.data import loader as jloader  # noqa: E402
from convnet_approximater_tpu_torch import data as tdata  # noqa: E402

NORM_TOL = 1e-6
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def test_synthetic_same_bytes_as_jax():
    for kw in (dict(split="train"), dict(split="validation", seed=3),
               dict(split="train", signal=0.4)):
        a = jdata.Synthetic(24, (10, 12, 3), 5, **kw)
        b = tdata.Synthetic(24, (10, 12, 3), 5, **kw)
        assert b.images.dtype == np.uint8 and b.images.shape == (24, 10, 12, 3)
        np.testing.assert_array_equal(b.images, a.images)
        np.testing.assert_array_equal(b.labels, a.labels)
        assert b.num_classes == 5


CASES = {
    "plain": dict(),
    "resized": dict(image_size=(16, 20)),
    "hflip": dict(aug=dict(hflip=0.5)),
    "crop_pad": dict(aug=dict(crop_pad=3, hflip=0.5)),
    "rrc_scale": dict(image_size=(14, 14), aug=dict(rrc_scale=(0.3, 1.0), hflip=0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_batches_match_jax(case):
    kw = CASES[case]
    ds = tdata.Synthetic(40, (12, 13, 3), 4, seed=2)
    jds = jdata.Synthetic(40, (12, 13, 3), 4, seed=2)
    jl = jdata.Loader(jds, 8, shuffle=True, mean=MEAN, std=STD, seed=5, prefetch=0, **kw)
    tl = tdata.Loader(ds, 8, shuffle=True, mean=MEAN, std=STD, seed=5, device="cpu", **kw)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        order = tl._indices()
        np.testing.assert_array_equal(order, jl._indices())
        jbatches = list(jl)
        tbatches = list(tl)
        assert len(tbatches) == len(jbatches) == 5
        for i, ((jx, jy), (tx, ty)) in enumerate(zip(jbatches, tbatches)):
            idx = order[i * 8:(i + 1) * 8]
            # the uint8 gather against the JAX loader's numpy route
            u8, labels = tl.gather(idx)
            pool = jds.images
            if jl.aug:
                rs = np.random.RandomState((5 * 1000003 + epoch * 9176 + int(idx[0])) % 2 ** 31)
                params = jloader.draw_aug_params(rs, 8, 12, 13, **jl.aug)
                ref = jloader.apply_aug(pool[idx], params, jl.image_size or (12, 13))
            else:
                ref = pool[idx]
                if jl.image_size is not None:
                    ref = jloader._resize_nearest(ref, jl.image_size)
            assert u8.dtype == np.uint8
            np.testing.assert_array_equal(u8, ref)
            # the normalised batch: NCHW, channels_last (an NHWC block), int64 labels
            assert tx.dtype == torch.float32 and ty.dtype == torch.int64
            assert tx.is_contiguous(memory_format=torch.channels_last)
            nhwc = tx.permute(0, 2, 3, 1).numpy()
            assert nhwc.shape == np.asarray(jx).shape
            np.testing.assert_allclose(nhwc, np.asarray(jx), rtol=NORM_TOL, atol=NORM_TOL)
            np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
            np.testing.assert_array_equal(labels, np.asarray(jy))


def test_augment_batch_matches_jax():
    pool = np.random.RandomState(0).randint(0, 256, (6, 11, 9, 3), dtype=np.uint8)
    for kw in (dict(hflip=1.0), dict(crop_pad=2), dict(rrc_scale=(0.2, 0.9), out_size=(7, 8))):
        a = jloader.augment_batch(pool, np.random.RandomState(4), **kw)
        b = tdata.augment_batch(pool, np.random.RandomState(4), **kw)
        np.testing.assert_array_equal(b, a)


def test_loader_length_drop_last_and_prefetch():
    ds = tdata.Synthetic(30, (6, 6, 3), 4)
    assert len(tdata.Loader(ds, 8, drop_last=True, device="cpu")) == 3
    loader = tdata.Loader(ds, 8, drop_last=False, prefetch=0, device="cpu")
    batches = list(loader)
    assert len(loader) == 4 and [b[0].shape[0] for b in batches] == [8, 8, 8, 6]
    pre = list(tdata.Loader(ds, 8, drop_last=False, prefetch=2, device="cpu"))
    for (a, la), (b, lb) in zip(batches, pre):
        assert torch.equal(a, b) and torch.equal(la, lb)


def test_loader_abandoned_iteration_releases_worker():
    """Breaking out of a prefetching epoch early (max_steps_per_epoch) must not
    strand the prefetch worker on a full queue."""
    ds = tdata.Synthetic(64, (8, 8, 3), 4)
    loader = tdata.Loader(ds, 4, shuffle=False, prefetch=2, device="cpu")
    before = threading.active_count()
    for _ in range(3):
        it = iter(loader)
        next(it)
        it.close()
    deadline = time.time() + 10.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_loader_worker_failure_reaches_the_consumer():
    ds = tdata.Synthetic(16, (8, 8, 3), 4)
    loader = tdata.Loader(ds, 4, prefetch=2, device="cpu")

    def broken(idx):
        raise RuntimeError("gather failed")

    loader.gather = broken
    with pytest.raises(RuntimeError, match="gather failed"):
        list(loader)


def test_unknown_aug_keys_raise():
    ds = tdata.Synthetic(8, (8, 8, 3), 4)
    for aug in (dict(flip=0.5), dict(rand_aug=dict(n=2, m=9), auto_augment="rand-m9-n2")):
        with pytest.raises(ValueError, match="unknown augmentation"):
            tdata.Loader(ds, 4, aug=aug, device="cpu")
    tdata.Loader(ds, 4, aug=dict(rand_aug=dict(n=2, m=9)), device="cpu")  # known since ported


def test_datasets_registry_npz_and_missing_files(tmp_path):
    ds = tdata.build_dataset(dict(type="Synthetic", num_samples=8, image_size=(4, 4, 3)))
    assert len(ds) == 8
    p = str(tmp_path / "d.npz")
    np.savez(p, train_images=np.zeros((4, 8, 8, 3), np.uint8), train_labels=np.arange(4))
    assert len(tdata.Npz(p, split="train")) == 4
    with pytest.raises(FileNotFoundError, match="no network download"):
        tdata.CIFAR10(str(tmp_path), split="train")
    with pytest.raises(FileNotFoundError, match="ImageFolder"):
        tdata.build_dataset(dict(type="ImageFolder", root=str(tmp_path / "nope")),
                            split="train")


def test_cifar10_reads_the_python_batches_as_jax(tmp_path):
    import pickle

    rs = np.random.RandomState(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rs.randint(0, 256, (3, 3 * 32 * 32), dtype=np.uint8),
             b"labels": list(rs.randint(0, 10, 3))}
        with open(tmp_path / name, "wb") as f:
            pickle.dump(d, f)
    for split in ("train", "validation"):
        a = jdata.CIFAR10(str(tmp_path), split=split)
        b = tdata.CIFAR10(str(tmp_path), split=split)
        np.testing.assert_array_equal(b.images, a.images)
        np.testing.assert_array_equal(b.labels, a.labels)


def test_image_folder_matches_jax(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    for ci, cname in enumerate(["cat", "dog"]):
        d = tmp_path / "train" / cname
        d.mkdir(parents=True)
        for j in range(3):
            arr = np.random.RandomState(10 * ci + j).randint(0, 256, (12, 14, 3), dtype=np.uint8)
            Image.fromarray(arr).save(d / f"img{j}.png")
    cfg = dict(type="ImageFolder", root=str(tmp_path), image_size=(8, 8))
    a = jdata.build_dataset(cfg, split="train")
    b = tdata.build_dataset(cfg, split="train")
    assert b.classes == a.classes == ["cat", "dog"] and b.num_classes == 2
    np.testing.assert_array_equal(b.images, a.images)
    np.testing.assert_array_equal(b.labels, a.labels)
