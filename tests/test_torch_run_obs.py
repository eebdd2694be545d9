"""The training run's logs, goodput and profile in the port
(tpudl_torch.train.logging, tpudl_torch.obs.goodput, fit's spans and
histograms, tpudl_torch.train.profiling) against tpudl's on the CPU.

- ``MetricLogger`` writes tpudl's JSONL line for line, and the same
  span event and gauges;
- ``classify`` / ``classify_by_process`` / ``format_goodput`` give
  tpudl's results on the same records (float sums of the same values in
  the same order: held exactly);
- ``fit`` and ``evaluate`` over a compiled ResNetTiny step record
  tpudl's spans (names, categories, step tags) and histograms, and the
  goodput report of the port's records has steps, data waits and a
  compile; without a recorder fit reads back nothing more;
- ``fit(profile_dir=)`` writes a Chrome trace of its window, and
  ``summarize_trace`` gives known totals on a hand-written trace.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpudl.obs as jobs
from tpudl.obs import counters as jcounters
from tpudl.obs import goodput as jgoodput
from tpudl_torch import obs
from tpudl_torch.obs import counters
from tpudl_torch.obs import goodput
from tpudl_torch.train import profiling
from tpudl_torch.train.logging import MetricLogger


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    """Observability state is process-global; isolate every test."""
    monkeypatch.delenv("TPUDL_OBS_DIR", raising=False)
    monkeypatch.delenv("TPUDL_PROFILE_DIR", raising=False)
    for o, c in ((obs, counters), (jobs, jcounters)):
        o.disable()
        c.registry().reset()
    yield
    for o, c in ((obs, counters), (jobs, jcounters)):
        o.disable()
        c.registry().reset()


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_metric_logger_writes_tpudls_lines(tmp_path, caplog):
    import logging

    from tpudl.train.logging import MetricLogger as JMetricLogger

    rows = [(1, {"loss": 0.5, "accuracy": 0.9}),
            (2, {"loss": np.float32(0.25), "accuracy": torch.tensor(0.95)}),
            (7, {"loss": 1 / 3, "step": 3.0, "ts": -1.5})]
    records = []
    for cls, o, d in ((MetricLogger, obs, "port"),
                      (JMetricLogger, jobs, "tpudl")):
        rec = o.enable(str(tmp_path / f"obs-{d}"))
        with cls(str(tmp_path / d), tensorboard=False) as ml:
            for step, m in rows:
                ml(step, {k: (float(v) if d == "tpudl" else v)
                          for k, v in m.items()})
        records.append(rec.records)
        o.disable()
    got = (tmp_path / "port" / "metrics.jsonl").read_text()
    assert got == (tmp_path / "tpudl" / "metrics.jsonl").read_text()
    assert len(got.splitlines()) == 3
    assert json.loads(got.splitlines()[0]) == {"step": 1, "loss": 0.5,
                                               "accuracy": 0.9}
    strip = ("ts", "host", "pid")
    assert [{k: v for k, v in r.items() if k not in strip}
            for r in records[0]] == [
        {k: v for k, v in r.items() if k not in strip} for r in records[1]]
    assert counters.registry().snapshot()["gauges"]["metric_loss"] == \
        jcounters.registry().snapshot()["gauges"]["metric_loss"] == 1 / 3
    ml = MetricLogger(log_dir=None)
    with caplog.at_level(logging.INFO, logger="tpudl_torch.metrics"):
        ml.log(3, {"loss": 0.125})
    assert "step=3 loss=0.125" in caplog.text


def test_metric_logger_tensorboard_is_guarded(tmp_path, monkeypatch):
    """With torch.utils.tensorboard importable a tfevents file appears
    beside the JSONL; where it does not import, JSONL only."""
    import builtins

    with MetricLogger(str(tmp_path / "tb"), tensorboard=True) as ml:
        ml.log(1, {"loss": 1.0})
    files = os.listdir(tmp_path / "tb")
    assert "metrics.jsonl" in files
    try:
        import torch.utils.tensorboard  # noqa: F401
        assert any("tfevents" in f for f in files)
    except Exception:
        assert files == ["metrics.jsonl"]
    real = builtins.__import__

    def no_tensorboard(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with MetricLogger(str(tmp_path / "plain"), tensorboard=True) as ml:
        ml.log(2, {"loss": 0.5})
    assert os.listdir(tmp_path / "plain") == ["metrics.jsonl"]


def _span(cat, ts, dur, host="h", process=0, **kw):
    return {"kind": "span", "name": cat, "cat": cat, "ts": float(ts),
            "dur": float(dur), "host": host, "process": process, **kw}


def _record_sets():
    timeline = [_span("compile", 1, 5)]
    t = 6.0
    for _ in range(10):
        timeline += [_span("data_wait", t, 0.2), _span("step", t + 0.2, 0.8)]
        t += 1.0
    timeline += [_span("checkpoint", t, 1.0), _span("metric_wait", t + 1, 0.5),
                 _span("recovery", t + 2, 0.25), _span("ckpt_bg", 0, 30)]
    rng = np.random.default_rng(0)
    mixed = []
    for i in range(60):
        cat = ["step", "eval", "data_wait", "compile", "restart", "worker",
               "step"][int(rng.integers(0, 7))]
        mixed.append(_span(cat, rng.uniform(0, 50), rng.uniform(0, 2),
                           host=f"h{i % 2}", process=i % 3,
                           pid=int(rng.integers(10, 12)),
                           window=int(rng.integers(1, 4))))
    mixed.append({"kind": "event", "name": "metrics", "ts": 3.0})
    return {"timeline": timeline, "mixed": mixed,
            "gaps": [_span("step", 0, 1), _span("restart", 1, 2),
                     _span("step", 5, 1)],
            "empty": []}


@pytest.mark.parametrize("name", ["timeline", "mixed", "gaps", "empty"])
def test_goodput_classifies_as_tpudl(name):
    records = _record_sets()[name]
    got, want = goodput.classify(records), jgoodput.classify(records)
    assert got == want
    assert goodput.format_goodput(got) == jgoodput.format_goodput(want)
    got = goodput.classify(records, window=(-1.0, 100.0))
    assert got == jgoodput.classify(records, window=(-1.0, 100.0))
    by = goodput.classify_by_process(records)
    assert by == jgoodput.classify_by_process(records)
    for cls in by["per_process"].values():
        assert goodput.format_goodput(cls) == jgoodput.format_goodput(cls)
    if name == "timeline":
        cls = goodput.classify(records)
        assert (cls["wall_s"], cls["compile_s"], cls["steps"]) == \
            (30.0, 5.0, 10)
        assert cls["productive_s"] == pytest.approx(8.0, abs=1e-12)


def _states():
    """tpudl's and the port's ResNetTiny on the same weights."""
    import optax

    from tpudl.models.resnet import ResNetTiny
    from tpudl.train import TrainState as JTrainState
    from tpudl_torch.config import OptimConfig
    from tpudl_torch.models import resnet
    from tpudl_torch.train import create_train_state, make_optimizer

    jmodel = ResNetTiny(num_classes=4, dtype=jnp.float32)
    v = jax.jit(lambda x: jmodel.init(jax.random.key(0), x, train=False))(
        jnp.zeros((1, 16, 16, 3)))
    jstate = JTrainState.create(apply_fn=jmodel.apply, params=v["params"],
                                batch_stats=v["batch_stats"],
                                tx=optax.sgd(0.05))
    state = create_train_state(
        0, resnet.ResNetTiny(num_classes=4, dtype=torch.float32,
                             device="meta"),
        make_optimizer(OptimConfig(name="sgd", learning_rate=0.05,
                                   warmup_steps=0, schedule="constant",
                                   momentum=0.0, weight_decay=0.0,
                                   grad_clip_norm=None)),
        params=resnet.params_from_tpudl(v["params"], v["batch_stats"], "cpu"),
        device="cpu")
    return jstate, state


def _batches(n, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(batch, 16, 16, 3)).astype(np.float32),
             "label": rng.integers(0, 4, batch).astype(np.int32)}
            for _ in range(n)]


def _shape(records):
    """A run's record stream without its clocks and process tags."""
    out = []
    for r in records:
        if r["kind"] == "span":
            out.append(("span", r["name"], r["cat"], r.get("step"),
                        r.get("phase")))
        elif r["kind"] == "event":
            out.append(("event", r["name"], r.get("step")))
        else:
            h = r["data"]["histograms"]
            out.append(("counters", tuple(sorted(
                (k, h[k]["count"]) for k in h
                if k in ("step_time_s", "data_wait_s", "compile_time_s")))))
    return out


def test_fit_and_evaluate_record_tpudls_spans(tmp_path, one_thread):
    """Eight steps of a compiled ResNetTiny step and an evaluate over
    three batches, logged every 4 steps through MetricLogger: the port
    records tpudl's spans, events and histogram counts in tpudl's order;
    goodput classifies the port's records with steps, data waits and a
    compile, and the categories sum to the wall clock."""
    from tpudl.runtime.mesh import MeshSpec, make_mesh
    from tpudl.train import compile_step as jcompile
    from tpudl.train import evaluate as jevaluate
    from tpudl.train import fit as jfit
    from tpudl.train import make_classification_eval_step as jeval_step
    from tpudl.train import make_classification_train_step as jstep
    from tpudl.train.logging import MetricLogger as JMetricLogger
    from tpudl_torch.train import (
        compile_step,
        evaluate,
        fit,
        make_classification_eval_step,
        make_classification_train_step,
    )

    jstate, state = _states()
    mesh = make_mesh(MeshSpec(dp=1), jax.devices()[:1])
    jtrain = jcompile(jstep(), mesh, jstate, None, donate_state=False)
    jeval = jcompile(jeval_step(), mesh, jstate, None, donate_state=False,
                     has_rng=False)
    train = compile_step(make_classification_train_step(), state)
    ev = compile_step(make_classification_eval_step(), state, has_rng=False)
    shapes = []
    for run in ("tpudl", "port"):
        o = jobs if run == "tpudl" else obs
        rec = o.enable(str(tmp_path / f"obs-{run}"))
        logger = (JMetricLogger if run == "tpudl" else MetricLogger)(
            str(tmp_path / f"log-{run}"), tensorboard=False)
        if run == "tpudl":
            jstate, m, info = jfit(jtrain, jstate, iter(_batches(8)),
                                   jax.random.key(1), log_every=4,
                                   logger=logger)
            jevaluate(jeval, jstate, iter(_batches(3, seed=1)))
        else:
            state, m, info = fit(train, state, iter(_batches(8)), 1,
                                 log_every=4, logger=logger)
            evaluate(ev, state, iter(_batches(3, seed=1)))
        logger.close()
        assert info["steps"] == 8
        records = rec.records
        shapes.append(_shape(records))
        o.disable()
    assert shapes[1] == shapes[0]
    assert ("counters", (("compile_time_s", 1), ("data_wait_s", 8),
                         ("step_time_s", 7))) in shapes[1]
    lines = (tmp_path / "log-port" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [4, 8]
    cls = goodput.classify(records)
    assert cls["steps"] == 7 and cls["productive_s"] > 0
    assert cls["data_wait_s"] > 0 and cls["compile_s"] > 0
    assert cls["eval_s"] > 0
    parts = sum(cls[k] for k in ("productive_s", "eval_s", "compile_s",
                                 "data_wait_s", "metric_wait_s",
                                 "checkpoint_s", "recovery_s", "other_s",
                                 "idle_s"))
    assert abs(parts - cls["wall_s"]) <= 0.01 * cls["wall_s"]
    assert "goodput" in goodput.format_goodput(cls)


class _CountedFloat:
    """A metric whose every read back to the host is counted."""

    reads = 0

    def __float__(self):
        _CountedFloat.reads += 1
        return 0.5


def test_fit_without_a_recorder_reads_nothing_back(tmp_path, monkeypatch):
    """No recorder: fit records nothing and reads the metrics back once,
    at the end; a recorder adds spans but no readback."""
    from tpudl_torch.train import fit

    class State:
        step = 0

    def step(state, batch, rng):
        state.step += 1
        return state, {"loss": _CountedFloat()}

    monkeypatch.chdir(tmp_path)
    for enabled in (False, True):
        _CountedFloat.reads = 0
        if enabled:
            rec = obs.enable(str(tmp_path / "obs"))
        _, last, info = fit(step, State(), iter(range(5)), 0)
        assert info["steps"] == 5 and last == {"loss": 0.5}
        assert _CountedFloat.reads == 1
        assert info["profile_trace"] is None
    assert obs.active_recorder() is rec
    cats = [r["cat"] for r in rec.records if r["kind"] == "span"]
    assert cats == ["data_wait", "step"] * 5
    obs.disable()
    assert sorted(p.name for p in tmp_path.rglob("*.jsonl")) == [
        os.path.basename(rec.path)]


def test_fit_profile_window_writes_a_trace(tmp_path, monkeypatch, one_thread):
    """profile_dir (or TPUDL_PROFILE_DIR) records steps [a, b) of a
    compiled step, skipping the compile call, each under a tpudl_step#
    annotation, into one Chrome trace; on the CPU it holds no device
    events, which summarize_trace refuses by name."""
    from tpudl_torch.train import (
        compile_step,
        fit,
        make_classification_train_step,
    )

    _, state = _states()
    train = compile_step(make_classification_train_step(), state)
    monkeypatch.setenv("TPUDL_PROFILE_DIR", str(tmp_path / "prof"))
    state, _, info = fit(train, state, iter(_batches(5)), 1,
                         profile_window=(0, 3))
    path = info["profile_trace"]
    assert os.path.dirname(path) == str(tmp_path / "prof")
    assert path.endswith(".pt.trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = sorted(e["name"] for e in events
                   if e.get("cat") == "user_annotation")
    # Step 0 is the compile call: the window opens at step 1.
    assert marks == ["tpudl_step#1", "tpudl_step#2"]
    with pytest.raises(ValueError, match="no device events"):
        profiling.summarize_trace(str(tmp_path / "prof"))
    # A window past the last batch closes with the loop.
    state, _, info = fit(train, state, iter(_batches(2)), 1,
                         profile_dir=str(tmp_path / "late"),
                         profile_window=(1, 9))
    assert os.path.exists(info["profile_trace"])


def _trace_file(path):
    """Two profiled steps on two streams: 6 device events, two of them
    overlapping; a gap of 100 us between the steps."""
    def x(cat, name, ts, dur, tid=7):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
                "ts": ts, "dur": dur}

    events = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
        x("user_annotation", "tpudl_step#2", 1000.0, 250.0, tid=1),
        x("user_annotation", "tpudl_step#3", 1400.0, 200.0, tid=1),
        x("cpu_op", "aten::mm", 1010.0, 30.0, tid=1),
        x("kernel", "void norm_fwd_rows_kernel<__nv_bfloat16, 4>(...)",
          1050.0, 40.0),
        x("kernel", "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", 1090.0,
          100.0),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>(...)",
          1150.0, 60.0, tid=8),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1420.0, 20.0),
        x("kernel", "void norm_fwd_rows_kernel<__nv_bfloat16, 4>(...)",
          1450.0, 40.0),
        x("kernel", "xent_fwd_rows_kernel(float const*, ...)", 1600.0, 50.0),
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def test_summarize_trace_gives_known_totals(tmp_path, capsys):
    _trace_file(tmp_path / "h_1.5.pt.trace.json")
    s = profiling.summarize_trace(str(tmp_path))
    assert s["steps"] == 2 and s["num_events"] == 6
    assert s["kernels_per_step"] == 3.0
    # Device time: 40+100+60+20+40+50 = 310 us over 2 steps.
    assert s["total_ms_per_step"] == pytest.approx(0.155, abs=1e-12)
    # Window: 1000 -> 1650 (the last kernel outlives its annotation).
    assert s["window_ms_per_step"] == pytest.approx(0.325, abs=1e-12)
    # Busy: [1050, 1210) + [1420, 1440) + [1450, 1490) + [1600, 1650).
    assert s["busy_ms_per_step"] == pytest.approx(0.135, abs=1e-12)
    assert s["busy_share"] == pytest.approx(270 / 650, abs=1e-12)
    assert s["idle_share"] == pytest.approx(380 / 650, abs=1e-12)
    kinds = s["by_category"]
    assert list(kinds) == ["this repo's kernels", "GEMM (cuBLAS)",
                           "other elementwise", "other"]
    assert kinds["this repo's kernels"]["ms_per_step"] == \
        pytest.approx(0.065, abs=1e-12)
    assert kinds["other"]["share"] == pytest.approx(20 / 310, abs=1e-12)
    assert s["ours"] == pytest.approx({"norm_fwd_rows_kernel": 0.04,
                                       "xent_fwd_rows_kernel": 0.025})
    assert s["top_ops"][0]["name"].startswith("nvjet")
    assert s["top_ops"][1]["calls_per_step"] == 1.0
    assert profiling.summarize_trace(str(tmp_path), steps=1)[
        "total_ms_per_step"] == pytest.approx(0.31, abs=1e-12)
    assert profiling.main([str(tmp_path), "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "0.155 ms/step" in out and "idle 58.5%" in out
    assert profiling.main([str(tmp_path), "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["steps"] == 2
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "none"))


def test_kernel_kinds_classify_names():
    kind = profiling.device_kind
    for name in ("norm_bwd_rows_kernel", "norm_bwd_wide_kernel",
                 "norm_bwd_scalar_kernel", "norm_colsum_kernel",
                 "quant_gemm_kernel", "quant_gemm_tma_kernel",
                 "quant_split_sum_kernel", "quant_gemv_kernel",
                 "quant_gemv_mma_kernel", "column_sum_kernel"):
        assert kind(f"void (anonymous namespace)::{name}<float, 1, 4>(...)") \
            == "this repo's kernels", name
    # The hand-written int8/e4m3 product is not a cuBLAS GEMM.
    assert kind("void quant_gemm_tma_kernel<0, 128>(CUtensorMap)") != \
        "GEMM (cuBLAS)"
    assert kind("cudnn::bn_fw_tr_1C11_kernel_NCHW") == "batch norm"
    assert kind("sm90_xmma_fprop_implicit_gemm_bf16") == \
        "convolutions (cuDNN)"
    assert kind("nvjet_tst_64x8_64x16") == "GEMM (cuBLAS)"
    assert kind("void (anonymous)::softmax_warp_forward<float, 7>") == \
        "softmax"
    assert kind("void at::native::reduce_kernel<512, 1>") == "reductions"
    assert kind("Memcpy DtoD (Device -> Device)") == "other"
    assert profiling.kernel_stem("void swiglu_fwd_kernel<bf16>(x)") == \
        "swiglu_fwd_kernel"
