"""The port's CAM methods and CLI (``convnet_approximater_tpu_torch/visualization/cam.py``)
against the JAX package's, on the CPU.

* every feature and gradient method on the same seeded feats and grads
  (NHWC for JAX, NCHW for the port) within 1e-4 (relative norm); the
  activations carry one dominant spatial component, so the principal
  component that eigencam and eigengradcam project on is well separated
  from the next (a near-tie of two would make any two SVDs disagree);
* scorecam and ablationcam with the JAX tests' closed-form score functions;
* fullgrad's completeness (FullGrad's Proposition 1) on the JAX tests'
  conv-BN-ReLU net, and its heatmap against JAX's on the same weights;
* the CLI: ``attn``, a gradient method and a re-forward method on a tiny
  MSCAN, against the JAX script on the same checkpoint and image, within 1e-4;
  ablationcam within 1e-3: its weights are the drops of the class score when
  one channel is zeroed, about 2e-3 of the score here, so the two packages'
  scores, 3.6e-7 apart (two float32 ulps of 1.63), give weights 1.5e-4 apart
  and a heatmap 5.7e-4 apart (measured on this case).
"""

import importlib.util
import os
import sys
from unittest import mock

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from convnet_approximater_tpu import visualization as jcam  # noqa: E402
from convnet_approximater_tpu_torch import nn as tnn  # noqa: E402
from convnet_approximater_tpu_torch.convert import params_from_jax  # noqa: E402
from convnet_approximater_tpu_torch.utils.serialize import flatten_tree  # noqa: E402
from convnet_approximater_tpu_torch.visualization import cam  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
ABLATION_TOL = 1e-3  # see the module doc: differences of near-equal scores


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def feats_grads(seed=0, h=6, w=7, c=8):
    """Activations with one dominant spatial component (a rank-1 map plus
    noise) and gradients of mixed sign, NHWC."""
    rs = np.random.RandomState(seed)
    feats = (3 * np.outer(rs.rand(h * w), rs.rand(c)).reshape(1, h, w, c)
             + 0.3 * rs.randn(1, h, w, c)).astype(np.float32)
    return feats, rs.randn(1, h, w, c).astype(np.float32)


@pytest.mark.parametrize("name", sorted(n for n, (_, k) in cam.CAM_METHODS.items()
                                        if k in ("grad", "feat")))
def test_feature_and_gradient_methods_match_jax(name):
    """The eigen methods: JAX's heatmap is the relu of the port's projection
    with one of its two signs (JAX picks it by the sign of a sum that is zero
    but for rounding), and the port's keeps the pixel of largest magnitude."""
    feats, grads = feats_grads()
    jfn, kind = jcam.CAM_METHODS[name]
    fn, kind_t = cam.CAM_METHODS[name]
    assert kind == kind_t
    if kind == "grad":
        h_j = jfn(jnp.asarray(feats), jnp.asarray(grads))
        h = fn(nchw(feats), nchw(grads))
    else:
        h_j, h = jfn(jnp.asarray(feats)), fn(nchw(feats))
    h_j, h = np.asarray(h_j), h.numpy()
    assert h.shape == (6, 7) and np.all(h >= 0) and np.abs(h).max() > 0
    if not name.startswith("eigen"):
        assert rel(h, h_j) < TOL
        return
    maps = nchw(feats)[0] * (nchw(grads)[0] if kind == "grad" else 1.0)
    proj = cam._eigen_projection(maps).numpy()
    assert min(rel(np.maximum(proj, 0), h_j), rel(np.maximum(-proj, 0), h_j)) < TOL
    peak = proj.flat[np.abs(proj).argmax()]
    assert rel(h, np.maximum(np.sign(peak) * proj, 0)) < TOL


def test_eigencam_sign_follows_the_peak_not_the_sum():
    """A centred projection sums to zero: the sign rule reads its peak."""
    rs = np.random.RandomState(2)
    s = rs.rand(5, 5)
    s[1, 3] = 6.0  # one strong pixel: after centring it stays the largest
    v = rs.rand(4)
    maps = torch.from_numpy((s[None] * v[:, None, None]).astype(np.float32))
    proj = cam._eigen_projection(maps).numpy()
    assert abs(proj.sum()) < 1e-4 * np.abs(proj).sum()
    h = cam.eigencam(maps[None]).numpy()
    assert h[1, 3] == h.max() > 0
    # a principal component has no sign: the maps negated give the same heatmap
    np.testing.assert_allclose(cam.eigencam(-maps[None]).numpy(), h, rtol=1e-5, atol=1e-6)


def test_scorecam_matches_jax():
    """The JAX test's classifier that fires on the top-left quadrant, on a
    random image, with random activations."""
    rs = np.random.RandomState(1)
    x = rs.rand(1, 16, 16, 3).astype(np.float32)
    a = np.maximum(rs.randn(1, 4, 4, 40), 0).astype(np.float32)  # 40 channels: two chunks

    def jprob(xb):
        return jnp.mean(xb[:, :8, :8, :], axis=(1, 2, 3))

    def prob(xb):
        assert xb.shape[0] <= cam.SCORE_CHUNK
        return xb[:, :, :8, :8].mean(dim=(1, 2, 3))

    h_j = np.asarray(jcam.scorecam(jnp.asarray(a), jnp.asarray(x), jprob))
    h = cam.scorecam(nchw(a), nchw(x), prob).numpy()
    assert rel(h, h_j) < TOL and h[:2, :2].mean() > 0


def test_ablationcam_matches_jax_and_the_closed_form():
    feats, _ = feats_grads(3, 4, 4, 40)
    feats = np.maximum(feats, 0)
    k = np.random.RandomState(4).randn(40).astype(np.float32)
    h_j = np.asarray(jcam.ablationcam(jnp.asarray(feats), lambda y: jnp.sum(y * k)))
    kt = torch.from_numpy(k)[None, :, None, None]
    h = cam.ablationcam(nchw(feats), lambda y: (y * kt).sum(dim=(1, 2, 3))).numpy()
    s = float((feats * k).sum())
    expect = np.maximum((feats[0] * (k * feats[0].sum((0, 1)) / abs(s))).sum(-1), 0.0)
    assert rel(h, h_j) < TOL and rel(h, expect) < TOL


class FullGradNet(torch.nn.Module):
    """The port's twin of the JAX test's conv-BN-ReLU net (bias-free conv1 and fc)."""

    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 4, 3, padding=1, bias=False)
        self.bn = tnn.BatchNorm2d(4)
        self.relu1 = tnn.ReLU()
        self.conv2 = tnn.Conv2d(4, 8, 3, padding=1, bias=True)
        self.relu2 = tnn.ReLU()
        self.pool = tnn.AdaptiveAvgPool2d(1)
        self.fc = tnn.Linear(8, 5, bias=False)

    def forward(self, x):
        x = self.pool(self.relu2(self.conv2(self.relu1(self.bn(self.conv1(x))))))
        return self.fc(x.flatten(1))


def fullgrad_pair():
    from tests.test_cam import _fullgrad_net

    jm, variables = _fullgrad_net()
    net = FullGradNet()
    net.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in flatten_tree(variables).items()}))
    return jm, variables, net.eval()


def test_fullgrad_completeness_and_terms_match_jax():
    jm, variables, net = fullgrad_pair()
    x = np.random.RandomState(5).randn(1, 8, 8, 3).astype(np.float32)
    xt = nchw(x)
    with torch.no_grad():
        f = float(net(xt)[0, 2])
    g_x, terms = cam.fullgrad_terms(net, xt, 2)
    assert set(terms) == {"bn", "conv2"}  # the bias-free conv1 and the Linear are no sites
    total = float((g_x * xt).sum()) + sum(float((g * b[:, None, None]).sum())
                                          for g, b in terms.values())
    assert abs(total - f) <= TOL * abs(f)
    jg_x, jterms = jcam.fullgrad_terms(jm, variables, jnp.asarray(x), 2)
    assert rel(g_x.permute(0, 2, 3, 1).numpy(), np.asarray(jg_x)) < TOL
    for p, (g, b) in terms.items():
        assert rel(g.permute(0, 2, 3, 1).numpy(), np.asarray(jterms[p][0])) < TOL
        assert rel(b.numpy(), np.asarray(jterms[p][1])) < TOL


def test_fullgrad_heatmap_matches_jax():
    jm, variables, net = fullgrad_pair()
    x = np.random.RandomState(6).randn(1, 8, 8, 3).astype(np.float32)
    h_j = np.asarray(jcam.fullgrad(jm, variables, jnp.asarray(x), 0))
    h = cam.fullgrad(net, nchw(x), 0).numpy()
    assert h.shape == (8, 8) and np.all(np.isfinite(h)) and np.all(h >= 0)
    assert rel(h, h_j) < TOL
    assert cam.CAM_METHODS["fullgrad"] == (cam.fullgrad, "model")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_cam_script", os.path.join(REPO, "scripts", "visualization", "cam.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("method", ["attn", "gradcam++", "ablationcam"])
def test_cli_matches_the_jax_script(tmp_path, method):
    """Both CLIs on a tiny MSCAN from one checkpoint and one image, without
    matplotlib (each then writes its heatmap as .npy)."""
    from convnet_approximater_tpu.models import build_model as jbuild
    from convnet_approximater_tpu.utils.serialize import save_model
    from tests.test_torch_prune_passes import randomized

    model_cfg = dict(type="MSCAN_Classifier", num_channels=(8, 16, 24, 32),
                     num_blocks=(1, 1, 1, 1), exp_ratios=(2, 2, 2, 2), num_classes=4)
    cfg = tmp_path / "tiny_mscan.py"
    cfg.write_text(f"model = {model_cfg!r}\n")
    ckpt = str(tmp_path / "w.npz")
    save_model(randomized(jbuild(dict(model_cfg)), seed=3), ckpt)
    img = tmp_path / "img.npy"
    np.save(img, np.random.RandomState(0).randint(0, 256, (64, 64, 3)).astype(np.uint8))
    common = ["--config", str(cfg), "--checkpoint", ckpt, "--method", method,
              "--image", str(img), "--block", "1"]
    script = _jax_script()
    with mock.patch.dict(sys.modules, {"matplotlib": None}):
        with mock.patch.object(sys, "argv", ["cam.py"] + common
                               + ["--out", str(tmp_path / "jax"), "--platform", "cpu"]):
            script.main()
        heat = cam.main(common + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    name = f"cam_{method}_block1.npy"
    h_j = np.load(tmp_path / "jax" / name)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / name), heat)
    assert heat.shape == h_j.shape and np.all(np.isfinite(heat)) and np.all(heat >= 0)
    assert rel(heat, h_j) < (ABLATION_TOL if method == "ablationcam" else TOL)
