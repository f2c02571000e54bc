"""The ``Dummy`` app, the ``Fps`` hook and ``InferenceTimeHook``'s profiler
tables of the port, on the CPU at small sizes.

* ``Dummy``: a model without ``DummyLayer`` registers no site in either
  package, and the port's Runner runs its phases and hooks over none (the
  configs' ``dummy_*`` files, through the CLI).
* ``Fps``: ``total_iters`` forwards per run, the first ``num_warmup`` untimed,
  on batches on the runner's device; no loader thread outlives the hook.
* The profiler capture of a ``MscaRepProfile`` MSCAN through the CLI: a
  Chrome trace under ``work_dir/traces/``, the ``op``/``source``/``category``
  tables with ``row_limit`` and ``exclude``, and the ``CONV0``/``SD_CONVS``/
  ``CHANNEL_MIX`` ranges.  On the CPU the tables hold operators' CPU time; the
  attribution of kernels to their launching scopes is held on recorded events
  shaped as the card's.
* The options: ``ClassInference`` in bf16 and the hook's ``bf16`` are taken
  (bf16 serves now); an unknown table option is refused.
"""

import os
import threading
from collections import namedtuple
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402

from convnet_approximater_tpu_torch import main as cli  # noqa: E402
from convnet_approximater_tpu_torch.utils import trace  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_MSCAN = ("model = dict(num_channels=(8, 16, 24, 32), num_blocks=(1, 1, 2, 1),\n"
              "             exp_ratios=(2, 2, 2, 2), num_classes=16)\n")


def run_cli(tmp_path, base, text):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"_base_ = [{os.path.join(REPO, 'configs', base)!r}]\n" + text)
    work = tmp_path / "run"
    runner = cli.main(["--config", str(cfg), "--device", "cpu", "--seed", "0",
                       "--work-dir", str(work)])
    return runner, work


# -- Dummy -------------------------------------------------------------------------

@pytest.mark.parametrize("base,model", [
    ("msca-rep/dummy_mscan-t.py", TINY_MSCAN),
    ("low-rank-exp/dummy_alexnet.py", ""),
], ids=["mscan-t", "alexnet"])
def test_dummy_registers_no_site_and_runs_the_hooks(tmp_path, base, model):
    from convnet_approximater_tpu.runner import Runner as JRunner
    from convnet_approximater_tpu.utils import config as jcfg

    runner, work = run_cli(tmp_path, base, model + (
        "hooks = [dict(type='ModelAnalysis', priority=40, input_shape=(64, 64, 3),\n"
        "              batch_size=1),\n"
        "         dict(type='InferenceTimeHook', priority=50,\n"
        "              infer_cfg=dict(input_size=(1, 64, 64, 3), num_iters=1, warmup=1))]\n"))
    log = (work / "run.log").read_text()
    assert runner.model.length_switchable == 0 and "0 switchable submodules: []" in log
    assert [h.forwards for h in runner.hooks] == [1, 2]
    assert "Model MACs: " in log and "Forward time (batch 1): median" in log
    assert os.path.exists(runner.output_path)
    jcfg.init_cfg(str(tmp_path / "cfg.py"))
    jcfg.update_cfg(work_dir=str(tmp_path / "jax"))
    jrunner = JRunner()
    jrunner.model.register_switchable(jrunner.app.src_type, jrunner.filters)
    assert jrunner.model.length_switchable == 0


def test_dummy_substitutes_a_dummy_layer_with_itself():
    """On a DummyLayer site (no parameters) the app's phases give the identity."""
    from convnet_approximater_tpu_torch.core import Dummy
    from convnet_approximater_tpu_torch.layers import DummyLayer

    app = Dummy()
    sub = app.initialize(DummyLayer())
    app.optimize(sub)
    out = app.postprocess(sub)
    x = torch.randn(1, 3, 4, 4)
    assert isinstance(out, DummyLayer) and torch.equal(out(x), x)


# -- Fps ---------------------------------------------------------------------------

def _loader_threads():
    return [t for t in threading.enumerate() if t.name.endswith("(worker)")]


def test_fps_times_the_loader_driven_forwards(tmp_path):
    from convnet_approximater_tpu_torch.hooks import Fps

    before = len(_loader_threads())
    runner, work = run_cli(tmp_path, "msca-rep/fps/msca-rep_d1_mscan-t_fps.py", TINY_MSCAN + (
        "hooks = [dict(type='Fps', priority=50, repeat_times=2, log_interval=3,\n"
        "              total_iters=7, num_warmup=2, dataset_args=dict(batch_size=2),\n"
        "              data_config=dict(image_size=(32, 32)))]\n"))
    hook = runner.hooks[0]
    assert isinstance(hook, Fps) and runner.model.length_switchable == 5
    assert set(hook.result) == {"average_fps", "fps_variance", "timed_images", "device"}
    assert hook.result["average_fps"] > 0 and hook.result["device"] == "cpu"
    assert hook.result["timed_images"] == (7 - 2) * 2
    assert hook.forwards == 2 * 7
    log = (work / "run.log").read_text()
    assert "[run 2] iter [3/7]" in log and "[run 2] iter [6/7]" in log
    assert "Average fps of 2 runs" in log
    assert len(_loader_threads()) == before  # every prefetch thread was joined

    # each forward gets one batch of (2, 3, 32, 32) on the runner's device
    seen = []
    handle = runner.model.register_forward_pre_hook(
        lambda m, args: seen.append((args[0].device, tuple(args[0].shape))))
    try:
        hook.repeat_times, hook.forwards = 1, 0
        hook.after_run()
    finally:
        handle.remove()
    assert seen == [(runner.device, (2, 3, 32, 32))] * 7 and hook.forwards == 7
    assert len(_loader_threads()) == before


# -- the profiler capture ------------------------------------------------------------

@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """The profiler config with MscaRepProfile(1, fix) on a tiny MSCAN through the CLI."""
    runner, work = run_cli(
        tmp_path_factory.mktemp("profile"), "msca-rep/profiler/msca-rep-profile_d1_fix_mscan-t.py",
        TINY_MSCAN + (
            "hooks = [dict(type='InferenceTimeHook', priority=50, infer_cfg=dict(\n"
            "    input_size=(1, 64, 64, 3), num_iters=1, warmup=1,\n"
            "    profile_args=dict(capture=True),\n"
            "    table_args=dict(row_limit=4, exclude=['aten::as_strided'])))]\n"))
    return runner, work


def test_capture_writes_a_trace_beside_the_timing(profiled):
    runner, work = profiled
    hook = runner.hooks[0]
    assert hook.capture_trace and hook.forwards == 1 + 1 + 1  # warm-up, timed, capture
    assert len(hook.result["times"]) == 1  # the capture is not timed
    traces = os.listdir(work / "traces")
    assert traces == ["cfg.pt.trace.json"] and (work / "traces" / traces[0]).stat().st_size
    log = (work / "run.log").read_text()
    for gb in ("op", "source", "category", "range"):
        assert f"Profile by {gb}:" in log


@pytest.mark.parametrize("group_by,expect", [
    ("op", "aten::"), ("source", ".py("), ("category", "aten::")])
def test_capture_tables(profiled, group_by, expect):
    table = profiled[0].hooks[0].result["tables"][group_by]
    head, rule, *rows, total = table.splitlines()
    assert head.split()[0] == group_by and set(rule) == {"-"}
    assert 1 <= len(rows) <= 4  # row_limit
    assert expect in rows[0] and not any("aten::as_strided" in r for r in rows)  # exclude
    assert total.startswith("TOTAL (CPU self time, no device)")


def test_capture_splits_msca_profile_stages(profiled):
    prof = profiled[0].hooks[0].result["profile"]
    ranges = trace.range_times(prof)
    for stage in ("CONV0", "SD_CONVS", "CHANNEL_MIX"):
        us, n = ranges[stage]
        assert us > 0 and n > 0, stage
    assert "SD_CONVS" in profiled[0].hooks[0].result["tables"]["range"]


# the card's records, made up as the profiler gives them: an aten op under CONV0 whose
# kernel it claims; a port wrapper's range under CONV0, whose kernel nothing claims but
# whose span on the device holds it; a port kernel and a copy outside any range
Kernel = namedtuple("Kernel", "name device duration")


def _event(name, parent=None, kernels=(), device=DeviceType.CPU, span=(0.0, 0.0), id=0,
           **kw):
    start, end = span
    return SimpleNamespace(
        name=name, id=id, cpu_parent=parent, kernels=list(kernels), device_type=device,
        device_index=0, time_range=SimpleNamespace(start=start, end=end,
                                                   elapsed_us=lambda: end - start),
        stack=kw.get("stack"), is_python_function=kw.get("py", False),
        is_user_annotation=kw.get("user", False), self_cpu_time_total=0.0)


def test_device_records_attribute_kernels_to_their_launching_scope():
    frame = _event("/x/convnet_approximater_tpu_torch/layers/msca.py(110): forward", py=True)
    conv0 = _event("CONV0", frame, user=True, id=1)
    conv = _event("aten::cudnn_convolution", conv0, [Kernel("implicit_gemm", 0, 30.0)], id=2)
    wrapper = _event("lowrank_conv", conv0, user=True, id=3)
    cuda = DeviceType.CUDA
    events = [frame, conv0, conv, wrapper,
              _event("CONV0", device=cuda, span=(0.0, 100.0), id=1, user=True),
              _event("lowrank_conv", device=cuda, span=(40.0, 95.0), id=3, user=True),
              _event("implicit_gemm", device=cuda, span=(5.0, 35.0)),
              _event("lowrank_kernel<4>", device=cuda, span=(42.0, 92.0)),
              _event("lowrank_kernel<4>", device=cuda, span=(200.0, 220.0)),  # no range
              _event("Memcpy HtoD", device=cuda, span=(300.0, 305.0))]
    prof = SimpleNamespace(events=lambda: events)
    records, on_device = trace.device_records(prof)
    assert on_device and sum(r.us for r in records) == 105.0  # the spans are not kernels
    assert trace.range_times(prof) == {"CONV0": [80.0, 2], "lowrank_conv": [50.0, 1]}
    by = {gb: trace.summarize_trace(prof, group_by=gb) for gb in trace.GROUPS}
    assert "layers/msca.py(110): forward" in by["source"] and "(no source)" in by["source"]
    category = {r.split("|")[0].strip(): r.split("|")[1].strip()
                for r in by["category"].splitlines()[2:-1]}
    # the launch in the range and the one outside it, by the kernel's name
    assert category == {"lowrank_conv": "0.070", "aten::cudnn_convolution": "0.030",
                        "(no operator)": "0.005"}
    assert "TOTAL (device)" in by["op"] and "CONV0" not in by["op"]


# -- refusals ----------------------------------------------------------------------------

def _bf16_inference():
    from convnet_approximater_tpu_torch.runner import ClassInference
    from convnet_approximater_tpu_torch.utils import init_cfg

    init_cfg(os.path.join(REPO, "configs", "msca-rep", "dummy_mscan-t.py"))
    return ClassInference("unused.pt", dtype="bfloat16", device="cpu")


@pytest.mark.parametrize("build,match", [
    # deploy mode (the Dummy app's too) is ported, and serves bf16 with the BN fold on
    (_bf16_inference, None),
    (lambda: _hook(bf16=True), None),
    (lambda: _hook(table_args=dict(sort_by="cpu_time")), "table_args.sort_by"),
], ids=["dummy-deploy", "bf16", "unknown-table-arg"])
def test_unported_options_are_refused(build, match):
    if match is None:  # taken now: the serving type is bf16
        built = build()
        assert built.dtype == torch.bfloat16 and getattr(built, "fold_bn", True)
        return
    with pytest.raises(NotImplementedError, match=match):
        build()


def _hook(**infer_cfg):
    from convnet_approximater_tpu_torch.hooks import InferenceTimeHook

    return InferenceTimeHook(None, 50, infer_cfg=infer_cfg)
