"""The harness end to end at tiny sizes on the CPU: a run, its result line, the
check failing under a fault planted in the timed path, the controls, a cell
added from files alone, and the refusals of ``run.py``."""

import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import pytest
import torch
import tiny
from limits import control_reading

from benchkit import result, serve, spec

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
INFO = dict(platform="cpu", kind="cpu", count=1)


def run_cell(cell, seed=2 ** 31 + 5, seconds=0.2, trace=False, control=False):
    return serve.run(cell, seed, seconds, trace, CPU, time.perf_counter(), control=control)


@pytest.mark.parametrize("name", tiny.SERVE_CELLS)
def test_run_is_correct_and_reports_every_metric(name):
    cell = tiny.cell(name)
    out = run_cell(cell)
    assert out.correct and out.attempted >= cell.traffic["pool_batches"] and out.failed == 0
    line = result.line(cell, out, False, INFO)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(line)[-1] == "checks" and line["checks"]["answer_err"]["value"] < 1e-5
    assert all(v["value"] > 0 for v in line["metrics"].values())
    traced = run_cell(cell, trace=True)
    line = result.line(cell, traced, True, INFO)
    # no device on the CPU: what a CUDA trace gives is left out, the host's spans are there
    assert {"loader_wait_ms.serve", "mfu.serve"} <= set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert traced.correct and "busy_s" in line["device"] and "breakdown" in line


def test_same_seed_same_work():
    cell = tiny.cell("convnext_t.serve_int8_b128")
    a, b = run_cell(cell, seed=99, control=True), run_cell(cell, seed=99, control=True)
    for j in a.control["checked"]:
        assert torch.equal(a.control["ref"][j], b.control["ref"][j])


def altered_answer(compile_serving):
    """compile_serving whose graph serves one altered answer per batch: the
    top logit of its first row lowered below the rest."""
    def wrapped(model, *args):
        compiled, put = compile_serving(model, *args)

        def serve_altered(*a):
            y = compiled(*a)
            y[0, y[0].argmax()] -= 10 * y[0].abs().max() + 1
            return y
        return serve_altered, put
    return wrapped


@pytest.mark.parametrize("name", tiny.SERVE_CELLS)
def test_an_altered_answer_is_not_correct(name):
    from convnet_approximater_tpu_torch import deploy

    with mock.patch.object(deploy, "compile_serving", altered_answer(deploy.compile_serving)):
        out = run_cell(tiny.cell(name))
    assert not out.correct
    value, limit = out.checks[0][1:]
    assert value > 10 * limit


def test_int4_control_fails_the_int8_cell():
    cell = tiny.cell("convnext_t.serve_int8_b128")
    limit = cell.workload["limits"]["answer_err"]
    for seed in (1, 2, 3):
        out = run_cell(cell, seed=seed, control=True)
        assert out.checks[0][1] < limit < max(control_reading(cell, out.control, "int4").values())


@pytest.mark.cuda
def test_tf32_control_fails_the_f32_cell(cuda_device):
    """At the cell's own sizes, on three seeds."""
    cell = spec.load_cell("mscan_t.serve_f32_b128")
    limit = cell.workload["limits"]["answer_err"]
    for seed in (1, 2, 3):
        out = serve.run(cell, seed, 0.5, False, cuda_device, time.perf_counter(), control=True)
        assert out.correct
        assert max(control_reading(cell, out.control, "tf32").values()) > limit


def test_a_cell_added_from_files_alone(tmp_path):
    """A configuration, a traffic mix, a workload and a per-layer metric added as
    files and BENCHMARK.json entries: the harness finds and runs them."""
    for sub in ("traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / sub, tmp_path / sub)
    tiny.dump(tmp_path / "cfg.json", dict(family="mscan", model=tiny.MSCAN))
    tiny.dump(tmp_path / "traffic" / "tiny_mix.json", tiny.TRAFFIC)
    shutil.copy(BENCH / "workloads" / "mscan_t.serve_f32_b128.json",
                tmp_path / "workloads" / "tiny.serve.json")
    (tmp_path / "metrics" / "batches.serve.py").write_text(
        "def read(ctx):\n    return float(ctx.spans['batches'])\n")
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    bench["configs"].append(dict(name="tiny_cfg", source="x", file=str(tmp_path / "cfg.json"),
                                 reduced=[], why="x"))
    bench["workloads"].append(dict(name="tiny.serve", config="tiny_cfg", traffic="tiny_mix",
                                   chips=1, why="x"))
    bench["end_to_end"][0]["workloads"].append("tiny.serve")
    bench["per_layer"].append(dict(name="batches.serve", unit="1", better="higher",
                                   source="program_counter", layer="serve loop and loader",
                                   moves="serve_img_per_s"))
    cell = spec.load_cell("tiny.serve", bench, bench_dir=tmp_path)
    assert "batches.serve" in cell.readers and cell.traffic == tiny.TRAFFIC
    out = run_cell(cell, trace=True)
    line = result.line(cell, out, True, INFO)
    assert line["metrics"]["batches.serve"]["value"] == out.attempted


def test_reports_by_workloads_or_moves():
    assert spec.reports({"name": "setup_s"}, "any")
    assert not spec.reports({"name": "a", "workloads": ["b"]}, "any")
    assert spec.reports({"name": "m", "moves": "x"}, "any", {"x"})
    assert not spec.reports({"name": "m", "moves": "x"}, "any", {"y"})


def harness_files():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def test_no_harness_file_imports_jax_or_the_jax_package():
    found = {}
    for path in harness_files() + sorted((BENCH / "tests").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     and not node.level else [])
            bad = result.forbidden_modules(names)
            if bad:
                found[str(path)] = bad
    assert not found
    assert result.forbidden_modules(["convnet_approximater_tpu_torch.deploy", "numpy"]) == []
    assert result.forbidden_modules(["convnet_approximater_tpu.core", "jax.numpy"]) == [
        "convnet_approximater_tpu", "jax"]


def test_a_run_loads_no_jax_module():
    """Every module of the harness, and a whole run, in a fresh process."""
    modules = [p.relative_to(BENCH).with_suffix("").as_posix().replace("/", ".")
               for p in harness_files() if p.name != "__init__.py" and p.parent.name != "metrics"]
    code = f"""
import sys, time, importlib, json
sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH)!r}, {str(BENCH / 'tests')!r}]
for m in {modules!r}:
    importlib.import_module(m)
import torch, tiny
from benchkit import result, serve
cell = tiny.cell("convnext_t.serve_int8_b128")
out = serve.run(cell, 3, 0.1, True, torch.device("cpu"), time.perf_counter())
result.line(cell, out, True, {{}})
print(json.dumps(result.forbidden_modules()))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def run_py(cwd):
    return subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                           "mscan_t.serve_f32_b128", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_py_refuses_without_a_card():
    proc = run_py(BENCH.parent)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_run_py_refuses_without_the_program(tmp_path):
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmarks", ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "convnet_approximater_tpu_torch" in proc.stderr


RECOVER = "convnext_t.recover_r1_b32"


def test_recovery_is_correct_and_reports_every_metric():
    from benchkit import recover

    cell = tiny.cell(RECOVER)
    out = recover.run(cell, 2 ** 31 + 9, 0.2, True, CPU, time.perf_counter())
    assert out.correct and out.attempted >= 1
    assert [name for name, _, _ in out.checks] == list(recover.COMPARED)
    assert out.parts["leaves"] == 3 * sum(tiny.CONVNEXT["depths"])
    line = result.line(cell, out, True, INFO)
    assert "mfu.train" in line["metrics"] and list(line)[-1] == "checks"
    line = result.line(cell, out, False, INFO)
    assert set(line["metrics"]) == {"train_img_per_s", "setup_s"}


def unchanged_state():
    from convnet_approximater_tpu_torch.hooks import finetune

    return mock.patch.object(finetune.MaskedOptimizer, "step", lambda self, trainable: None)


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state"])
def test_a_faulty_recovery_step_is_not_correct(fault):
    from limits import half_batch

    from benchkit import recover

    with (half_batch() if fault == "half_batch" else unchanged_state()):
        out = recover.run(tiny.cell(RECOVER), 11, 0.2, False, CPU, time.perf_counter())
    assert not out.correct
    assert any(value > 10 * limit for _, value, limit in out.checks)


@pytest.mark.cuda
def test_tf32_control_fails_the_recovery_cell(cuda_device):
    """At the cell's own sizes, on three seeds."""
    from limits import recovery_reading

    from benchkit import recover

    cell = spec.load_cell(RECOVER)
    for seed in (1, 2, 3):
        out = recover.run(cell, seed, 0.5, False, cuda_device, time.perf_counter(), control=True)
        assert out.correct
        control = recovery_reading(cell, out.control, "tf32")
        assert any(control[name] > limit for name, _, limit in out.checks)


def test_kernel_names_and_busy_time():
    from benchkit import tracing

    assert tracing.base_name("void (anonymous namespace)::march_kernel<21, 5, 4, float>"
                             "(float const*, int)") == "march_kernel"
    assert tracing.base_name("qmatmul_kernel") == "qmatmul_kernel"
    assert tracing.base_name("void at::native::elementwise_kernel<128, 2>(int)") == "elementwise_kernel"
    assert tracing._union([(0, 2), (1, 3), (5, 6)]) == 4
    t = tracing.Trace(1.0, 0.5, {"void (anonymous namespace)::mix_kernel<4>(float*)": 0.25,
                                 "ring_kernel": 0.125})
    assert tracing.kernel_seconds(t, ("march_kernel", "mix_kernel")) == 0.25
