"""Serving and evaluating across processes in the port: the data-axis helpers
of ``parallel/mesh.py``, ``ValidateHelper(use_mesh=True)``, ``serve
--data-parallel`` and ``main.py``'s process-group flags, on gloo ranks on the
CPU (``tests/torch_ranks.py``).

Two ranks shard, pad and replicate (``replicate`` gives every rank rank 0's
weights), evaluate a tiny MSCAN (each loads only its rows of every global
batch, the sums go over the ranks) and serve an int8 artifact of
``configs/low-rank-exp/dummy_alexnet.py`` with ``--data-parallel`` at a batch
that splits over them and one that does not (each rank makes only its rows,
the batch tiled up to a multiple of the ranks); one process does both alone, and
the ranks must return its numbers: the counts exactly, the loss within 1e-6
(the ranks sum the same rows in another order), the served logits within
1e-6 relative (a slice is computed at another batch size).  Then ``main.py``
runs as two processes joined by ``--coordinator``: only rank 0 makes its work
dir and log.
"""

import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks  # noqa: E402
from convnet_approximater_tpu_torch import export_model, serve  # noqa: E402
from convnet_approximater_tpu_torch.classification.validate import ValidateHelper  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUMMY_ALEX = os.path.join(REPO, "configs", "low-rank-exp", "dummy_alexnet.py")
LOSS_TOL = 1e-6
LOGITS_RTOL = 1e-6
WORLD = 2


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving")
    artifact = str(d / "alex_sym.pt2")
    export_model.main(["--config", DUMMY_ALEX, "--out", artifact, "--batch", "2",
                       "--input-size", "64", "64", "3", "--quantize", "int8", "--device", "cpu",
                       "--dtype", "float32", "--symbolic-batch"])
    real = d / "real.json"
    rs = np.random.RandomState(3)
    real.write_text(json.dumps([[int(v) for v in rs.choice(16, rs.randint(0, 3), replace=False)]
                                for _ in range(32)]))
    eval_cfg = dict(batch_size=8, input_size=(16, 16, 3), num_classes=16, num_batches=3,
                    real_labels=str(real), log_freq=1)
    argvs = {b: ["--artifact", artifact, "--batch", str(b), "--batches", "2", "--min-batch", "1",
                 "--device", "cpu", "--data-parallel"] for b in (3, 4)}
    ranks = torch_ranks.spawn(torch_ranks.serving_job, WORLD, d / "ranks", eval_cfg=eval_cfg,
                              seed=5, serve_argvs=argvs)
    alone = dict(validate=ValidateHelper(torch_ranks.randomized("mscan", 5), eval_cfg,
                                         device="cpu").validate(),
                 serve={b: serve.main(argv[:-1]) for b, argv in argvs.items()})
    return ranks, alone


def test_the_data_axis_helpers(setup):
    from convnet_approximater_tpu_torch import parallel

    ranks, _ = setup
    rows = torch.arange(24.0).reshape(6, 4)
    for rank, res in enumerate(ranks):
        got = res["mesh"]
        assert got["sharding"] == (rank, WORLD) and got["count"] == WORLD
        assert got["main"] == (rank == 0)
        assert torch.equal(got["shard"], rows[3 * rank:3 * rank + 3])
        assert got["valid"] == 5 and torch.equal(got["padded"][:5], rows[:5])
        assert torch.equal(got["padded"][5:], torch.zeros(3, 4))
    # a batch that does not split is tiled up first, as pad_batch_to_multiple tiles it
    assert [list(parallel.shard_indices(np.arange(10, 13), (r, WORLD), pad=True))
            for r in range(WORLD)] == [[10, 11], [12, 10]]
    assert list(parallel.shard_indices(np.arange(4), (1, WORLD))) == [2, 3]
    with pytest.raises(ValueError, match="does not split over 2 data ranks"):
        parallel.shard_indices(np.arange(3), (0, WORLD))
    # every rank holds rank 0's weights after replicate, buffers too
    want = torch_ranks.randomized("resnet", 0).state_dict()
    for res in ranks:
        assert all(torch.equal(res["mesh"]["replica"][k], v) for k, v in want.items())
    # one process without a group: initialize_distributed does nothing
    assert parallel.initialize_distributed(device="cpu") == torch.device("cpu")
    assert parallel.process_count() == 1 and parallel.is_main_process()
    assert parallel.local_device_count() == 1


def test_data_parallel_validation_gives_the_numbers_of_one_process(setup):
    ranks, alone = setup
    want = alone["validate"]
    for res in ranks:
        got = res["validate"]
        assert math.isclose(got["loss"], want["loss"], rel_tol=LOSS_TOL)
        for key in ("top1", "top5", "real_top1", "real_top5", "param_count", "img_size"):
            assert got[key] == want[key], key


@pytest.mark.parametrize("batch", [3, 4], ids=["3 rows over 2 ranks", "4 rows over 2 ranks"])
def test_data_parallel_serve_gives_the_logits_of_one_process(setup, batch):
    ranks, alone = setup
    want = alone["serve"][batch]
    for res in ranks:
        got = res["serve"][batch]
        assert got["world"] == WORLD and got["min_batch"] == WORLD  # --min-batch 1 rose to 2
        assert got["served"] == want["served"] == 2 * batch
        assert got["rows"] == -(-batch // WORLD) and want["rows"] == batch  # each made its rows
        assert got["logits"].shape == want["logits"].shape == (batch, 10)
        assert rel(got["logits"], want["logits"]) < LOGITS_RTOL
    assert torch.equal(ranks[0]["serve"][batch]["logits"], ranks[1]["serve"][batch]["logits"])


def test_main_makes_the_work_dir_on_rank_0_only(tmp_path):
    cfg = tmp_path / "tiny_mscan.py"
    cfg.write_text(
        f"_base_ = [{os.path.join(REPO, 'configs/msca-rep/dummy_mscan-t.py')!r}]\n"
        f"model = dict(num_channels=(8, 16, 24, 32), num_blocks=(1, 1, 2, 1), "
        f"exp_ratios=(2, 2, 2, 2), num_classes=16)\n"
        f"hooks = []\n")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "convnet_approximater_tpu_torch.main", "--config", str(cfg),
         "--device", "cpu", "--work-dir", str(tmp_path / f"work_r{rank}"),
         "--coordinator", f"localhost:{port}", "--num-processes", str(WORLD),
         "--process-id", str(rank)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(WORLD)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    log = (tmp_path / "work_r0" / "run.log").read_text()
    assert "saved model to" in log and (tmp_path / "work_r0" / "tiny_mscan.pt").is_file()
    assert not (tmp_path / "work_r1").exists()
