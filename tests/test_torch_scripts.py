"""The port's counterparts of the last scripts against the JAX ones.

* ``ckpt_converter.add_substitution`` / ``remove_substitution`` give the JAX
  scripts' trees on the same checkpoint, round-trip to it, and their CLIs
  read an npz or a sharded checkpoint and write npz.
* ``visualization.visual_kernel.extract_kernels`` equals the JAX function on
  a depthwise conv and a CascadeConv; its CLI writes one image per checkpoint.
* ``low_rank_exp_spr`` on the CPU at one small shape and M = 2 writes the JAX
  script's CSV columns with its theoretical column, and a measured ratio.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from convnet_approximater_tpu_torch import low_rank_exp_spr as spr  # noqa: E402
from convnet_approximater_tpu_torch.ckpt_converter import add_substitution as tadd  # noqa: E402
from convnet_approximater_tpu_torch.ckpt_converter import remove_substitution as trm  # noqa: E402
from convnet_approximater_tpu_torch.utils import serialize as tser  # noqa: E402
from convnet_approximater_tpu_torch.utils import sharded_ckpt as sc  # noqa: E402
from convnet_approximater_tpu_torch.visualization import visual_kernel as tvk  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(rel: str):
    """A module of ``scripts/`` (which puts the repository on ``sys.path`` itself)."""
    name = "jax_script_" + rel.replace("/", "_").removesuffix(".py")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", rel))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[name] = module
    return sys.modules[name]


def flat_ckpt() -> dict:
    """A post-PostProcess checkpoint: two switchable sites (one with BN state)
    beside a head, a cascade and a depthwise conv."""
    rs = np.random.RandomState(0)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return tser.unflatten_tree({
        "params/features/3/s_conv/weight": f(3, 3, 1, 8),
        "params/features/3/d_conv/weight": f(1, 1, 8, 6),
        "params/features/3/d_conv/bias": f(6),
        "params/features/30/weight": f(3, 3, 6, 6),
        "params/features/6/conv/weight": f(3, 3, 6, 4),
        "state/features/6/bn/mean": f(4),
        "params/head/weight": f(4, 2),
        "params/blk/sd_convs/conv1/weight": f(1, 7, 1, 5),
        "params/blk/sd_convs/conv2/weight": f(7, 1, 1, 5),
        "params/blk/sd_convs/conv2/bias": f(5),
        "params/blk/dw/weight": f(5, 5, 1, 5),
        "meta/epoch": np.int64(3),
    })


PATHS = ["features.3", "features.6"]


def same_flat(a: dict, b: dict):
    a, b = tser.flatten_tree(a), tser.flatten_tree(b)
    assert set(a) == set(b)
    assert all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("branch,keep_other", [("new", False), ("old", False), ("new", True)])
def test_substitution_rewrites_match_jax_and_round_trip(branch, keep_other):
    jadd = jax_script("ckpt_converter/add_substitution.py").add_substitution
    jrm = jax_script("ckpt_converter/remove_substitution.py").remove_substitution
    tree = flat_ckpt()
    wrapped = tadd.add_substitution(tree, PATHS, branch, keep_other)
    same_flat(wrapped, jadd(tree, PATHS, branch, keep_other))
    keys = tser.flatten_tree(wrapped)
    assert f"params/features/3/{branch}/s_conv/weight" in keys
    assert "params/features/30/weight" in keys  # a sibling whose name extends a path's
    assert f"state/features/6/{branch}/bn/mean" in keys
    back = trm.remove_substitution(wrapped, branch)
    same_flat(back, jrm(wrapped, branch))
    same_flat(back, tree)


def test_substitution_clis_read_npz_and_sharded_and_write_npz(tmp_path):
    src = str(tmp_path / "flat.ckpt.npz")
    tser.save_model(flat_ckpt(), src)
    shard = sc.save_sharded(str(tmp_path / "flat.ckpt.dcp"), flat_ckpt())
    for i, path in enumerate((src, shard)):
        wrapped, back = str(tmp_path / f"w{i}.npz"), str(tmp_path / f"b{i}.npz")
        tadd.main([path, wrapped, "--paths", *PATHS])
        trm.main([wrapped, back])
        same_flat(tser.load_ckpt(wrapped), tadd.add_substitution(flat_ckpt(), PATHS))
        same_flat(tser.load_ckpt(back), flat_ckpt())


def test_extract_kernels_matches_jax_and_the_cli_writes_images(tmp_path):
    jextract = jax_script("visualization/visual_kernel.py").extract_kernels
    tree = flat_ckpt()
    for path in ("blk.sd_convs", "blk.dw"):
        got, want = tvk.extract_kernels(tree, path), jextract(tree, path)
        assert got.shape == want.shape == (5, 7 if "sd" in path else 5, 7 if "sd" in path else 5)
        assert np.array_equal(got, want)
    with pytest.raises(KeyError, match="no kernel"):
        tvk.extract_kernels(tree, "blk.missing")
    npz = str(tmp_path / "k.ckpt.npz")
    tser.save_model(tree, npz)
    shard = sc.save_sharded(str(tmp_path / "s.ckpt.dcp"), tree)
    written = tvk.main([npz, shard, "--path", "blk.sd_convs", "--out", str(tmp_path / "out")])
    assert [os.path.basename(w).rsplit(".", 1)[0] for w in written] == ["k.ckpt", "s.ckpt"]
    assert all(os.path.getsize(w) > 0 for w in written)


def test_spr_cli_writes_the_jax_scripts_csv(tmp_path, monkeypatch):
    shape = [(4, 6, 3, 1, 1, 6)]
    jspr = jax_script("low_rank_exp_spr.py")
    monkeypatch.setattr(jspr, "ALEXNET_SHAPES", shape)
    monkeypatch.setattr(spr, "ALEXNET_SHAPES", shape)
    monkeypatch.setattr(sys, "argv", ["spr", "--batch", "2", "--bases", "2", "--out",
                                      str(tmp_path / "jax")])
    jspr.main()
    result = spr.main(["--batch", "2", "--bases", "2", "--out", str(tmp_path / "port"),
                       "--device", "cpu"])
    jrows = open(tmp_path / "jax" / "spr.csv").read().strip().split("\n")
    trows = open(result["csv"]).read().strip().split("\n")
    assert trows[0] == jrows[0] == "shape,num_bases,theoretical_spr,measured_spr"
    assert [r.split(",")[:3] for r in trows[1:]] == [r.split(",")[:3] for r in jrows[1:]]
    assert trows[1].split(",")[:3] == ["4x6x3", "2", f"{9 * 4 * 6 / (4 * 2 * (6 + 6)):.3f}"]
    (row,) = result["rows"]
    assert row["measured_spr"] > 0 and row["refused"] is None
    assert float(trows[1].split(",")[3]) == float(f"{row['measured_spr']:.3f}")
    assert type(row["module"]).__name__ == "LowRankExpConvV1" and row["module"].num_base == 2
