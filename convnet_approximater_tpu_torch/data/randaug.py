"""RandAugment on the host in numpy (port of
``convnet_approximater_tpu/data/randaug.py``, the same ops and the same
``RandomState`` draw order, so both packages give the same bytes).

Cubuk et al.'s RandAugment: for each image draw ``n`` ops uniformly from a
fixed pool and apply them at one global magnitude ``m`` (0..10).  The pool is
timm's default without its PIL-interpolation colour op; the ops take uint8 HWC
arrays, and the geometric ones sample the nearest source pixel of the inverse
map with reflected edges, as ``loader.apply_aug`` does.  The ``Loader`` runs it
on the gathered uint8 batch before the crop and flip draws.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rand_augment_batch", "RAND_AUG_OPS"]


def _reflect(idx: np.ndarray, size: int) -> np.ndarray:
    idx = np.abs(idx)
    over = idx > size - 1
    idx = np.where(over, 2 * (size - 1) - idx, idx)
    return np.clip(idx, 0, size - 1)


def _affine(img: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """Inverse-map ``img`` through the 2x3 affine ``mat`` (about center),
    nearest sampling, reflected edges."""
    H, W = img.shape[:2]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    r, c = np.meshgrid(np.arange(H) - cy, np.arange(W) - cx, indexing="ij")
    sr = mat[0, 0] * r + mat[0, 1] * c + mat[0, 2] + cy
    sc = mat[1, 0] * r + mat[1, 1] * c + mat[1, 2] + cx
    ri = _reflect(np.round(sr).astype(np.int64), H)
    ci = _reflect(np.round(sc).astype(np.int64), W)
    return img[ri, ci]


def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = a.astype(np.float32) + factor * (b.astype(np.float32) - a.astype(np.float32))
    return np.clip(out, 0, 255).astype(np.uint8)


# -- the op pool (img uint8 HWC, m in [0, 10], rs for sign draws) -----------

def _autocontrast(img, m, rs):
    out = img.astype(np.float32)
    lo = out.min(axis=(0, 1), keepdims=True)
    hi = out.max(axis=(0, 1), keepdims=True)
    scale = np.where(hi > lo, 255.0 / np.maximum(hi - lo, 1e-6), 1.0)
    off = np.where(hi > lo, -lo * scale, 0.0)
    return np.clip(out * scale + off, 0, 255).astype(np.uint8)


def _equalize(img, m, rs):
    out = np.empty_like(img)
    for ch in range(img.shape[2]):
        hist = np.bincount(img[..., ch].ravel(), minlength=256)
        nz = hist[hist > 0]
        if nz.size <= 1:
            out[..., ch] = img[..., ch]
            continue
        step = (hist.sum() - nz[-1]) // 255
        if step == 0:
            out[..., ch] = img[..., ch]
            continue
        lut = (np.cumsum(hist) - hist) // step
        out[..., ch] = np.clip(lut, 0, 255).astype(np.uint8)[img[..., ch]]
    return out


def _posterize(img, m, rs):
    bits = max(1, int(round(8 - 4 * m / 10)))  # m=10 -> 4 bits dropped
    mask = np.uint8(0xFF << (8 - bits) & 0xFF)
    return img & mask


def _solarize(img, m, rs):
    thresh = int(round(255 - 255 * m / 10 * 0.75))
    return np.where(img >= thresh, 255 - img, img).astype(np.uint8)


def _brightness(img, m, rs):
    f = 1.0 + rs.choice([-1, 1]) * 0.9 * m / 10
    return _blend(np.zeros_like(img), img, f)


def _contrast(img, m, rs):
    f = 1.0 + rs.choice([-1, 1]) * 0.9 * m / 10
    mean = np.full_like(img, np.uint8(round(img.astype(np.float32).mean())))
    return _blend(mean, img, f)


def _sharpness(img, m, rs):
    f = 1.0 + rs.choice([-1, 1]) * 0.9 * m / 10
    x = img.astype(np.float32)
    # 3x3 smoothing (PIL SMOOTH kernel) with reflected edges
    p = np.pad(x, ((1, 1), (1, 1), (0, 0)), mode="reflect")
    sm = (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:] +
          p[1:-1, :-2] + 5 * p[1:-1, 1:-1] + p[1:-1, 2:] +
          p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]) / 13.0
    return _blend(np.clip(sm, 0, 255).astype(np.uint8), img, f)


def _rotate(img, m, rs):
    deg = rs.choice([-1, 1]) * 30.0 * m / 10
    th = np.deg2rad(deg)
    mat = np.array([[np.cos(th), -np.sin(th), 0.0],
                    [np.sin(th), np.cos(th), 0.0]])
    return _affine(img, mat)


def _shear_x(img, m, rs):
    s = rs.choice([-1, 1]) * 0.3 * m / 10
    return _affine(img, np.array([[1.0, 0.0, 0.0], [s, 1.0, 0.0]]))


def _shear_y(img, m, rs):
    s = rs.choice([-1, 1]) * 0.3 * m / 10
    return _affine(img, np.array([[1.0, s, 0.0], [0.0, 1.0, 0.0]]))


def _translate_x(img, m, rs):
    t = rs.choice([-1, 1]) * 0.45 * m / 10 * img.shape[1]
    return _affine(img, np.array([[1.0, 0.0, 0.0], [0.0, 1.0, -t]]))


def _translate_y(img, m, rs):
    t = rs.choice([-1, 1]) * 0.45 * m / 10 * img.shape[0]
    return _affine(img, np.array([[1.0, 0.0, -t], [0.0, 1.0, 0.0]]))


RAND_AUG_OPS = (
    ("AutoContrast", _autocontrast),
    ("Equalize", _equalize),
    ("Posterize", _posterize),
    ("Solarize", _solarize),
    ("Brightness", _brightness),
    ("Contrast", _contrast),
    ("Sharpness", _sharpness),
    ("Rotate", _rotate),
    ("ShearX", _shear_x),
    ("ShearY", _shear_y),
    ("TranslateX", _translate_x),
    ("TranslateY", _translate_y),
)


# the ops that draw from the stream: one sign each, rs.choice([-1, 1])
SIGNED_OPS = frozenset({"Brightness", "Contrast", "Sharpness", "Rotate", "ShearX", "ShearY",
                        "TranslateX", "TranslateY"})


def rand_augment_batch(images: np.ndarray, rs: np.random.RandomState,
                       n: int = 2, m: float = 9.0, first: int = 0,
                       total: int = None) -> np.ndarray:
    """Apply RandAugment(n, m) per image.  uint8 NHWC in/out; ``n=0`` is
    the identity.  ``images`` may be rows ``[first, first + len(images))``
    of a batch of ``total``: the stream is drawn for the whole batch (the
    other rows' ops drawn, not applied), so each row gets the ops it gets in
    the whole batch, as a rank of a data axis augments its rows."""
    if n <= 0:
        return images
    assert images.dtype == np.uint8, "RandAugment operates on uint8 images"
    total = len(images) if total is None else total
    out = np.empty_like(images)
    n_ops = len(RAND_AUG_OPS)
    for i in range(total):
        ops = [RAND_AUG_OPS[k] for k in rs.randint(0, n_ops, size=n)]
        if not first <= i < first + len(images):
            for name, _ in ops:
                if name in SIGNED_OPS:
                    rs.choice([-1, 1])
            continue
        img = images[i - first]
        for _, op in ops:
            img = op(img, m, rs)
        out[i - first] = img
    return out
