"""tpudl_torch.ft, the port's fault-tolerance layer, on the CPU: the
commit-or-invisible store (and its on-disk format against tpudl's, both
ways), the async writer (bounded stall, back-pressure, deferred errors),
the manager's full resume state restored in place, the resumable data
position (against tpudl's), preemption and the supervisor. Case by case
the counterpart of tests/test_ft.py."""

import hashlib
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tpudl_torch.config import OptimConfig
from tpudl_torch.data.synthetic import synthetic_classification_batches
from tpudl_torch.ft import chaos
from tpudl_torch.ft import preemption as ft_preemption
from tpudl_torch.ft.data import ResumableIterator
from tpudl_torch.ft.manager import AsyncCheckpointManager
from tpudl_torch.ft.store import (
    CheckpointCorruptError,
    CheckpointShapeError,
    CheckpointStore,
)
from tpudl_torch.ft.manager import state_payload
from tpudl_torch.ft.supervisor import (
    RestartPolicy,
    Supervisor,
    SupervisorGaveUp,
    resume_run,
)
from tpudl_torch.models.resnet import ResNetTiny
from tpudl_torch.obs import counters as obs_counters
from tpudl_torch.train import (
    compile_step,
    create_train_state,
    fit,
    make_classification_train_step,
    make_optimizer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """Torch's CPU ops on one thread (tests/test_torch_train.py's
    fixture): bit-for-bit comparisons of two runs, and no contention with
    the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_state(seed=0, num_classes=4):
    """ResNetTiny (BatchNorm statistics) with Nesterov SGD (traces)."""
    model = ResNetTiny(num_classes=num_classes, dtype=torch.float32,
                       device="meta")
    tx = make_optimizer(OptimConfig(
        name="sgd", learning_rate=0.05, momentum=0.9, warmup_steps=0,
        schedule="constant", grad_clip_norm=None))
    return create_train_state(seed, model, tx, device="cpu")


def _batches(n, seed=7):
    return list(synthetic_classification_batches(
        8, image_shape=(16, 16, 3), num_classes=4, num_batches=n, seed=seed))


def _state_tensors(state):
    """Every tensor of a state's payload and its host counters, by name."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for k, v in state.opt_state.items():
        if k == "scalars":
            continue
        if isinstance(v, dict):
            out.update({f"opt/{k}/{n}": t for n, t in v.items()})
        else:
            out[f"opt/{k}"] = torch.as_tensor(v)
    out["step"] = torch.tensor(state.step)
    return out


def _states_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        assert torch.equal(ta[k], tb[k]), k


# ---------------------------------------------------------------------------
# store: atomic commit protocol
# ---------------------------------------------------------------------------


def test_store_commit_and_visibility(tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"), max_to_keep=2)
    assert store.latest_step() is None
    assert store.write(3, [("a", torch.arange(6, dtype=torch.float32))])
    assert store.latest_step() == 3
    # Re-saving a committed step is a no-op, not corruption.
    assert not store.write(3, [("a", torch.zeros(6))])
    _, tensors = store.read(3)
    assert torch.equal(tensors["a"], torch.arange(6, dtype=torch.float32))
    # Retention keeps the newest max_to_keep.
    store.write(5, [("a", torch.ones(2))])
    store.write(7, [("a", np.ones(2, np.float32))])
    store.retain()
    assert store.all_steps() == [5, 7]
    assert os.path.basename(store.step_dir(7)) == "step_0000000007"


def test_store_uncommitted_is_invisible(tmp_path):
    """A crash mid-save (staging dir, or a final-named dir without the
    COMMIT marker) must never become the 'latest' restore picks up."""
    store = CheckpointStore(str(tmp_path / "ck"))
    store.write(2, [("a", torch.arange(4, dtype=torch.int32))])
    staged = store.stage(9)
    with open(os.path.join(staged, "payload.bin"), "wb") as f:
        f.write(b"partial")
    os.makedirs(store.step_dir(8))
    with open(os.path.join(store.step_dir(8), "payload.bin"), "wb") as f:
        f.write(b"torn")
    assert store.latest_step() == 2
    assert store.all_steps() == [2]
    assert len(store.gc_stale()) == 2
    assert store.latest_step() == 2


def test_store_commit_marker_removal_hides_step(tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"))
    store.write(1, [("a", torch.zeros(2))])
    store.write(4, [("a", torch.ones(2))])
    chaos.remove_commit_marker(str(tmp_path / "ck"), 4)
    assert store.latest_step() == 1


def test_store_truncation_detected(tmp_path):
    store = CheckpointStore(str(tmp_path / "ck"))
    store.write(1, [("a", torch.arange(1024, dtype=torch.float32))])
    chaos.truncate_checkpoint(str(tmp_path / "ck"), 1, keep_bytes=64)
    with pytest.raises(CheckpointCorruptError, match="truncated"):
        store.read(1)


def test_store_same_size_bitrot_detected(tmp_path):
    """In-place corruption that keeps the payload's length is caught by
    the checksum, not restored as garbage weights."""
    store = CheckpointStore(str(tmp_path / "ck"))
    store.write(1, [("a", torch.arange(1024, dtype=torch.float32))])
    payload = os.path.join(store.step_dir(1), "payload.bin")
    with open(payload, "r+b") as f:
        f.seek(512)
        f.write(b"\xff" * 16)
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        store.read(1)


def test_store_odd_offsets_and_empty_leaves_round_trip(tmp_path):
    """A bf16 leaf of odd length puts the next f32 leaf at an offset that
    is not a multiple of 4; 0-d, empty and channels_last leaves keep
    their shapes and values."""
    leaves = [("bf", torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)),
              ("f", torch.arange(5, dtype=torch.float32) / 3),
              ("scalar", torch.tensor(7, dtype=torch.int64)),
              ("empty", torch.zeros(0, 3)),
              ("cl", torch.arange(24.).reshape(1, 2, 3, 4).to(
                  memory_format=torch.channels_last)),
              ("flag", torch.tensor([True, False]))]
    store = CheckpointStore(str(tmp_path / "ck"))
    store.write(1, leaves)
    meta, tensors = store.read(1)
    assert [leaf["offset"] for leaf in meta["leaves"]][:2] == [0, 6]
    for key, want in leaves:
        assert tensors[key].dtype == want.dtype and \
            tensors[key].shape == want.shape, key
        assert torch.equal(tensors[key], want), key


# ---------------------------------------------------------------------------
# the on-disk format against tpudl's, both ways
# ---------------------------------------------------------------------------


def _format_leaves():
    """(numpy leaves for tpudl's store, the same leaves as tensors)."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    f32 = rng.normal(size=(3, 5)).astype(np.float32)
    bf16 = rng.normal(size=(7,)).astype(ml_dtypes.bfloat16)
    arrays = [("['params']['w']", f32),
              ("['params']['bf']", bf16),
              ("['opt_state']['count']", np.asarray(5, np.int64)),
              ("['ids']", rng.integers(-9, 9, (2, 4)).astype(np.int32)),
              ("['key']", rng.integers(0, 2**32, (2,), dtype=np.uint32)),
              ("['step']", np.asarray(12, np.int64))]
    tensors = [(k, torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                if a.dtype == ml_dtypes.bfloat16 else torch.from_numpy(a))
               for k, a in arrays]
    return arrays, tensors


def test_tpudl_store_writes_and_the_port_reads_the_same_bytes(tmp_path):
    """tpudl's store writes f32, bf16, int64, int32 and uint32 leaves
    (0-d ones among them); the port's reads each as a tensor of the same
    dtype, shape and bytes, with the data position beside them. Both
    stores write the same leaves byte for byte: the same payload and the
    same leaf table."""
    from tpudl.ft.store import CheckpointStore as JStore

    arrays, tensors = _format_leaves()
    JStore(str(tmp_path / "j")).write(
        12, arrays, extra_meta={"data_state": {"epoch": 0, "offset": 12}})
    meta, got = CheckpointStore(str(tmp_path / "j")).read(12)
    assert meta["data_state"] == {"epoch": 0, "offset": 12}
    for key, want in arrays:
        t = got[key]
        assert list(t.shape) == list(want.shape), key
        assert str(t.dtype).split(".")[-1] == str(want.dtype), key
        assert t.reshape(-1).view(torch.uint8).numpy().tobytes() == \
            want.tobytes(), key
    assert torch.equal(got["['params']['bf']"].float(),
                       torch.from_numpy(arrays[1][1].astype(np.float32)))
    CheckpointStore(str(tmp_path / "t")).write(
        12, tensors, extra_meta={"data_state": {"epoch": 0, "offset": 12}})
    jdir = JStore(str(tmp_path / "j")).step_dir(12)
    tdir = CheckpointStore(str(tmp_path / "t")).step_dir(12)
    for name in ("payload.bin", "COMMIT"):
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    jmeta = JStore(str(tmp_path / "j")).read_meta(12)
    assert jmeta == CheckpointStore(str(tmp_path / "t")).read_meta(12)


def test_port_store_writes_and_tpudl_reads_the_same_bytes(tmp_path):
    """The reverse: the port's store writes tensors (bf16 as its raw
    words), tpudl's store reads numpy arrays with the same bytes, and
    its bf16 leaf through ml_dtypes holds the same values; a truncated
    port checkpoint is corrupt to tpudl's store too."""
    from tpudl.ft.store import CheckpointCorruptError as JCorrupt
    from tpudl.ft.store import CheckpointStore as JStore

    arrays, tensors = _format_leaves()
    CheckpointStore(str(tmp_path / "t")).write(4, tensors)
    _, got = JStore(str(tmp_path / "t")).read(4)
    for key, want in arrays:
        assert got[key].dtype == want.dtype and got[key].shape == want.shape
        assert got[key].tobytes() == want.tobytes(), key
    np.testing.assert_array_equal(got["['params']['bf']"].astype(np.float32),
                                  arrays[1][1].astype(np.float32))
    chaos.truncate_checkpoint(str(tmp_path / "t"), 4)
    with pytest.raises(JCorrupt, match="truncated"):
        JStore(str(tmp_path / "t")).read(4)


def test_port_store_reads_bf16_without_ml_dtypes(tmp_path):
    """A bf16 checkpoint written by either package is read by the port's
    store in a process where ``ml_dtypes`` cannot be imported (the card's
    machine has no jax, and so no ml_dtypes)."""
    from tpudl.ft.store import CheckpointStore as JStore

    arrays, tensors = _format_leaves()
    JStore(str(tmp_path / "j")).write(1, arrays)
    CheckpointStore(str(tmp_path / "t")).write(1, tensors)
    want = [float(x) for x in arrays[1][1].astype(np.float32)]
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "from tpudl_torch.ft.store import CheckpointStore\n"
        "for d in sys.argv[1:]:\n"
        "    _, t = CheckpointStore(d).read(1)\n"
        "    bf = t[\"['params']['bf']\"]\n"
        "    assert str(bf.dtype) == 'torch.bfloat16', bf.dtype\n"
        "    print(bf.float().tolist())\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None "
        "and m.split('.')[0] in ('jax', 'ml_dtypes', 'tpudl'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "j"), str(tmp_path / "t")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [eval(line) for line in lines] == [want, want]


# ---------------------------------------------------------------------------
# manager: full-resume round-trip, stall bound, back-pressure, fallback
# ---------------------------------------------------------------------------


def test_manager_roundtrip_full_resume_state(tmp_path):
    state = _tiny_state()
    step = make_classification_train_step()
    for batch in _batches(2):
        state, _ = step(state, batch, 3)  # moments, statistics and counts
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        assert mgr.save(2, state, rng=123,
                        data_state={"epoch": 1, "offset": 5})
        mgr.wait_until_finished()
        fresh = _tiny_state(seed=9)
        restored, r_rng, r_data = mgr.restore_full(fresh)
    assert restored is fresh
    _states_equal(state, restored)
    assert restored.step == 2 and restored.opt_state["host_count"] == 2
    assert r_rng == 123
    assert r_data == {"epoch": 1, "offset": 5}


def test_async_save_stall_bounded_vs_sync(tmp_path, monkeypatch):
    """With an injected slow disk, the on-step stall of an async save
    stays a small fraction of the synchronous save's time."""
    delay = 0.5
    monkeypatch.setenv(chaos.ENV_IO_DELAY_S, str(delay))
    state = _tiny_state()
    with AsyncCheckpointManager(str(tmp_path / "async")) as mgr:
        t0 = time.perf_counter()
        mgr.save(1, state)
        async_stall = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgr.save(2, state, block=True)
        sync_time = time.perf_counter() - t0
        mgr.wait_until_finished()
        assert mgr.all_steps() == [1, 2]
    assert sync_time >= delay
    assert async_stall < sync_time / 2
    assert async_stall < delay / 2


def test_backpressure_at_most_one_inflight(tmp_path, monkeypatch):
    delay = 0.3
    monkeypatch.setenv(chaos.ENV_IO_DELAY_S, str(delay))
    state = _tiny_state()
    with AsyncCheckpointManager(str(tmp_path / "bp")) as mgr:
        t0 = time.perf_counter()
        mgr.save(1, state)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgr.save(2, state)  # waits for save 1 to commit
        second = time.perf_counter() - t0
        mgr.wait_until_finished()
        assert mgr.all_steps() == [1, 2]
    assert first < delay / 2
    assert second >= delay * 0.5


def test_save_is_a_copy_an_in_place_step_cannot_tear(tmp_path, monkeypatch):
    """The port's optimizer moves the parameters in place: a save taken
    just before a step, still being written under a slow disk while the
    step runs, restores the state from before that step."""
    monkeypatch.setenv(chaos.ENV_IO_DELAY_S, "0.3")
    state = _tiny_state()
    step = make_classification_train_step()
    batches = _batches(2)
    state, _ = step(state, batches[0], 1)
    before = {k: v.clone() for k, v in _state_tensors(state).items()}
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        mgr.save(1, state)
        state, _ = step(state, batches[1], 1)  # while the write sleeps
        assert not torch.equal(_state_tensors(state)["model/head.weight"],
                               before["model/head.weight"])
        mgr.wait_until_finished()
        restored = mgr.restore(_tiny_state(seed=4))
    got = _state_tensors(restored)
    for k, v in before.items():
        assert torch.equal(got[k], v), k


def test_corrupt_latest_falls_back_to_previous(tmp_path):
    state = _tiny_state()
    counter = obs_counters.registry().counter("ft_corrupt_checkpoints")
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        state.step = 2
        mgr.save(2, state, data_state={"epoch": 0, "offset": 2})
        state.step = 4
        mgr.save(4, state, data_state={"epoch": 0, "offset": 4})
        mgr.wait_until_finished()
        chaos.truncate_checkpoint(mgr.directory, 4)
        # Explicit step: the corruption is the caller's business.
        with pytest.raises(CheckpointCorruptError):
            mgr.restore(_tiny_state(seed=3), step=4)
        before = counter.value
        with pytest.warns(UserWarning, match="corrupt"):
            restored, _, data = mgr.restore_full(_tiny_state(seed=3))
    assert counter.value == before + 1
    assert restored.step == 2
    assert data == {"epoch": 0, "offset": 2}


@pytest.mark.parametrize("background", [True, False])
def test_restore_shape_mismatch_clear_error(tmp_path, background):
    """A changed model: a clear per-leaf error naming every path, not a
    copy_ crash — shapes (another head) and dtypes (AdamW's bf16 first
    moment against an f32 one), on both write modes. Nothing is
    restored."""
    from tpudl_torch.models.bert import BERT_TINY, BertForSequenceClassification

    state = _tiny_state(num_classes=4)
    wrong = _tiny_state(seed=1, num_classes=7)
    with AsyncCheckpointManager(str(tmp_path / "a"),
                                background=background) as mgr:
        mgr.save(0, state, block=True)
        head = wrong.model.head.weight.clone()
        with pytest.raises(CheckpointShapeError, match="head") as err:
            mgr.restore(wrong)
        assert "head.weight" in str(err.value) and \
            "head.bias" in str(err.value)
        assert torch.equal(wrong.model.head.weight, head)

    def bert(mu_dtype):
        model = BertForSequenceClassification(BERT_TINY(
            vocab_size=64, max_position_embeddings=16, dtype=torch.float32),
            device="meta")
        return create_train_state(0, model, make_optimizer(OptimConfig(
            mu_dtype=mu_dtype)), device="cpu")

    with AsyncCheckpointManager(str(tmp_path / "b"),
                                background=background) as mgr:
        mgr.save(0, bert("bfloat16"), block=True)
        with pytest.raises(CheckpointShapeError,
                           match="checkpoint has dtype bfloat16"):
            mgr.restore(bert("float32"))


def test_writer_error_is_deferred_not_swallowed(tmp_path):
    state = _tiny_state()
    mgr = AsyncCheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state)
    mgr.wait_until_finished()
    import shutil

    shutil.rmtree(mgr.directory)
    with open(mgr.directory, "w") as f:  # a FILE where the dir was
        f.write("not a directory")
    mgr.save(2, state)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait_until_finished()
    assert not mgr._writer.health()["healthy"]
    os.remove(mgr.directory)
    mgr.close()


def test_restore_refuses_a_mesh(tmp_path):
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        mgr.save(0, _tiny_state(), block=True)
        for kw in (dict(mesh="dp"), dict(rules=("fsdp",))):
            with pytest.raises(NotImplementedError, match="queue A item 7"):
                mgr.restore(_tiny_state(), **kw)


# ---------------------------------------------------------------------------
# resumable data position
# ---------------------------------------------------------------------------


def test_resumable_iterator_counts_and_seeks():
    it = ResumableIterator(iter(range(10)))
    assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
    assert it.state() == {"epoch": 0, "offset": 4}
    it2 = ResumableIterator(list(range(10)))
    it2.seek({"epoch": 0, "offset": 4})
    assert next(it2) == 4
    with pytest.raises(ValueError, match="epoch"):
        ResumableIterator(list(range(3))).seek({"epoch": 2, "offset": 0})
    with pytest.raises(ValueError, match="past end"):
        ResumableIterator(list(range(3))).seek({"epoch": 0, "offset": 5})


def test_resumable_iterator_epoch_factory_rollover():
    factory = lambda epoch: [(epoch, i) for i in range(3)]  # noqa: E731
    it = ResumableIterator(factory, epochs=2)
    assert list(it) == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert it.state() == {"epoch": 1, "offset": 3}
    it2 = ResumableIterator(factory, epochs=2).seek({"epoch": 1, "offset": 1})
    assert list(it2) == [(1, 1), (1, 2)]


def test_resumable_iterator_matches_tpudl():
    """Both packages' ResumableIterator give the same sequences and
    positions on one source: plain, factory rollover (endless too), and
    after a seek."""
    from tpudl.ft.data import ResumableIterator as JIter

    factory = lambda epoch: [(epoch, i) for i in range(3)]  # noqa: E731
    for make in (lambda cls: cls(list(range(7))),
                 lambda cls: cls(factory, epochs=3),
                 lambda cls: cls(factory, epochs=None),
                 lambda cls: cls(factory, epochs=3).seek(
                     {"epoch": 1, "offset": 2})):
        mine, theirs = make(ResumableIterator), make(JIter)
        for _ in range(8):
            a = next(mine, None)
            assert a == next(theirs, None)
            assert mine.state() == theirs.state()


# ---------------------------------------------------------------------------
# fit: full resume state, schedule-identical resume, preemption
# ---------------------------------------------------------------------------


def _run(state, batches, num_steps, mgr=None, every=0, rng=42, logger=None):
    step = compile_step(make_classification_train_step(), state)
    losses = []

    def log(i, m):
        losses.append(m["loss"])
        if logger is not None:
            logger(i, m)

    state, _, info = fit(step, state, batches, rng, num_steps=num_steps,
                         log_every=1, logger=log, checkpoint_manager=mgr,
                         checkpoint_every=every)
    return state, losses, info


def test_fit_resume_run_schedule_identical(tmp_path):
    """Kill/resume == uninterrupted on a ResNetTiny with BatchNorm
    statistics and SGD traces: the resumed run's losses and its final
    parameters, statistics, traces, counts and step equal the
    uninterrupted run's bit for bit (weights, moments, counters, seed and
    data position all round-trip; resume_run fast-forwards the data)."""
    total = 8
    control, losses, _ = _run(_tiny_state(),
                              ResumableIterator(_batches(total)), total)
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        _, head, _ = _run(_tiny_state(), ResumableIterator(_batches(total)),
                          4, mgr=mgr, every=2)
        assert mgr.latest_step() == 4
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr2:
        template = _tiny_state(seed=5)
        state, r_rng, batches, start = resume_run(
            mgr2, template, ResumableIterator(_batches(total)))
        assert state is template and start == 4 and r_rng == 42
        assert batches.state() == {"epoch": 0, "offset": 4}
        state, tail, _ = _run(state, batches, total - start, mgr=mgr2,
                              every=2, rng=r_rng)
        assert mgr2.all_steps() == [4, 6, 8]
    assert head + tail == losses
    _states_equal(control, state)


def test_resume_run_plain_iterable_keeps_position(tmp_path):
    """resume_run wraps plain iterables in a ResumableIterator (cold start
    AND resume), so the data position stays recorded across repeated
    restarts."""
    all_batches = _batches(8)
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        state, rng, batches, start = resume_run(mgr, _tiny_state(),
                                                list(all_batches))
        assert start == 0 and rng is None
        assert isinstance(batches, ResumableIterator)
        _run(state, batches, 3, mgr=mgr, every=2, rng=0)
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr2:
        state, rng, batches, start = resume_run(mgr2, _tiny_state(seed=2),
                                                list(all_batches))
        assert start == 3 and rng == 0
        assert batches.state() == {"epoch": 0, "offset": 3}
        _run(state, batches, 2, mgr=mgr2, every=2, rng=rng)
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr3:
        _, _, data = mgr3.restore_full(_tiny_state(seed=3))
        assert data == {"epoch": 0, "offset": 5}
        _, _, batches, start = resume_run(mgr3, _tiny_state(seed=3),
                                          list(all_batches))
        assert start == 5 and batches.state() == {"epoch": 0, "offset": 5}


def test_fit_saves_data_position(tmp_path):
    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        _run(_tiny_state(), ResumableIterator(_batches(5)), None, mgr=mgr,
             every=2, rng=0)
        assert mgr.all_steps() == [2, 4, 5]
        restored, rng, data = mgr.restore_full(_tiny_state(seed=1))
    assert restored.step == 5 and rng == 0
    assert data == {"epoch": 0, "offset": 5}


def test_preemption_triggers_emergency_checkpoint(tmp_path):
    """SIGTERM mid-fit: the loop stops, the emergency checkpoint commits
    at the interrupted step, info says preempted, the grace watchdog is
    disarmed on the cooperative path, and the guard's exit clears the
    flag (a later fit in this process trains)."""
    ft_preemption.reset()

    def send_sigterm(i, metrics):
        if i == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    with AsyncCheckpointManager(str(tmp_path / "ck")) as mgr:
        with ft_preemption.PreemptionGuard(grace_s=60.0):
            state, _, info = _run(
                _tiny_state(), ResumableIterator(_batches(10)), None,
                mgr=mgr, every=100, rng=0, logger=send_sigterm)
            assert ft_preemption.requested()
            assert ft_preemption.remaining_grace() > 0
        latest = mgr.latest_step()
        _, _, data = mgr.restore_full(_tiny_state(seed=1))
    assert info["preempted"] is True and info["steps"] == 3
    assert latest == 3 and data == {"epoch": 0, "offset": 3}
    assert not ft_preemption.requested()
    _, _, info = _run(state, _batches(2), None)
    assert info["steps"] == 2 and info["preempted"] is False


def test_preemption_guard_restores_handlers():
    ft_preemption.reset()
    before = signal.getsignal(signal.SIGTERM)
    with ft_preemption.PreemptionGuard(grace_s=1.0):
        assert signal.getsignal(signal.SIGTERM) is not before
    assert signal.getsignal(signal.SIGTERM) is before


# ---------------------------------------------------------------------------
# supervisor (a fake runner; chip_smoke.py's ft_kill drives a real one)
# ---------------------------------------------------------------------------


class _FlakyRunner:
    """Fails the first ``fail_times`` launches, then succeeds."""

    def __init__(self, fail_times):
        self.fail_times = fail_times
        self.launches = 0

    def run(self, fn, *args, **kwargs):
        self.launches += 1
        if self.launches <= self.fail_times:
            raise RuntimeError(f"worker exited with -9 (launch "
                               f"{self.launches})")
        return [fn(*args, **kwargs)]


def test_supervisor_restarts_until_success():
    sleeps = []
    runner = _FlakyRunner(fail_times=2)
    restarts = obs_counters.registry().counter("ft_restarts")
    before = restarts.value
    sup = Supervisor(runner, policy=RestartPolicy(
        max_restarts=3, backoff_s=0.01, backoff_factor=2.0,
        max_backoff_s=10.0), sleep=sleeps.append)
    assert sup.run(lambda x: x * 2, 21) == [42]
    assert runner.launches == 3 and sup.restarts == 2
    assert sleeps == [0.01, 0.02]  # exponential backoff
    assert restarts.value == before + 2
    assert len(sup.failures) == 2 and "launch 1" in sup.failures[0]


def test_supervisor_retry_budget_exhausted(monkeypatch):
    monkeypatch.setenv("TPUDL_FT_MAX_RESTARTS", "2")
    monkeypatch.setenv("TPUDL_FT_BACKOFF_S", "0")
    runner = _FlakyRunner(fail_times=99)
    sup = Supervisor(runner, sleep=lambda s: None)
    assert sup.policy.max_restarts == 2 and sup.policy.max_backoff_s == 30.0
    with pytest.raises(SupervisorGaveUp, match="retry budget") as err:
        sup.run(lambda: 1)
    assert runner.launches == 3 and err.value.attempts == 3
    assert isinstance(err.value.__cause__, RuntimeError)


def test_supervisor_nonrestartable_fails_fast():
    class _Bad:
        def run(self, fn, *a, **k):
            raise TypeError("programming error, do not retry")

    sup = Supervisor(_Bad(), sleep=lambda s: None)
    with pytest.raises(TypeError):
        sup.run(lambda: 1)
    assert sup.restarts == 0


# ---------------------------------------------------------------------------
# a kill and a supervised restart, in child processes
# ---------------------------------------------------------------------------


def _digest(state) -> str:
    """sha256 of every leaf of the state's payload, in payload order."""
    h = hashlib.sha256()
    from tpudl_torch.ft.manager import flatten_with_keys

    for key, t in flatten_with_keys(state_payload(state)):
        h.update(key.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _kill_worker(ckpt_dir, total, env, out_path):
    """The resume-idempotent payload (tests/ft_helpers.py's elastic_train
    on the port): resume from the newest committed checkpoint, train the
    rest of ``total`` steps with a checkpoint every 2, obey the
    environment's chaos kill, write (start, losses, digest)."""
    os.environ.update(env)
    torch.set_num_threads(1)
    state = _tiny_state()
    with AsyncCheckpointManager(ckpt_dir) as mgr:
        state, rng, batches, start = resume_run(
            mgr, state, ResumableIterator(_batches(total)))
        rng = 42 if rng is None else rng
        kill = chaos.step_kill_hook()
        losses = []

        def logger(i, metrics):
            losses.append(metrics["loss"])
            if kill is not None:
                # Drain the writer first, so which checkpoint is committed
                # at the kill is fixed.
                mgr.wait_until_finished()
                kill(start + i)

        step = compile_step(make_classification_train_step(), state)
        state, _, _ = fit(step, state, batches, rng, num_steps=total - start,
                          log_every=1, logger=logger, checkpoint_manager=mgr,
                          checkpoint_every=2)
    with open(out_path, "w") as f:
        json.dump({"start": start, "losses": losses,
                   "digest": _digest(state)}, f)


class _SpawnRunner:
    """A one-process runner: ``run(fn, *args)`` runs ``fn`` in a spawned
    child and raises RuntimeError on a non-zero exit; the child's last
    argument is the file it writes its result to."""

    def __init__(self):
        self.exitcodes = []

    def run(self, fn, *args):
        proc = multiprocessing.get_context("spawn").Process(target=fn,
                                                            args=args)
        proc.start()
        proc.join(120)
        if proc.is_alive():
            proc.kill()
            proc.join()
        self.exitcodes.append(proc.exitcode)
        if proc.exitcode != 0:
            raise RuntimeError(f"worker exited with {proc.exitcode}")
        with open(args[-1]) as f:
            return [json.load(f)]


def test_supervised_kill_resumes_to_the_uninterrupted_digest(tmp_path):
    """A child training 8 steps is SIGKILLed once at step 5 (the
    environment's TPUDL_CHAOS_* knobs); the supervisor restarts it, the
    new child resumes at the committed step 4 and ends with the digest of
    an uninterrupted run in a child of its own. Then a truncated newest
    step falls back to the one before it, counted once."""
    once = tmp_path / "once"
    once.mkdir()
    runner = _SpawnRunner()
    sup = Supervisor(runner, policy=RestartPolicy(max_restarts=2,
                                                  backoff_s=0.0),
                     sleep=lambda s: None)
    env = {chaos.ENV_KILL_AT_STEP: "5", chaos.ENV_ONCE_DIR: str(once)}
    ck = str(tmp_path / "ck")
    [resumed] = sup.run(_kill_worker, ck, 8, env, str(tmp_path / "a.json"))
    assert runner.exitcodes == [-signal.SIGKILL, 0] and sup.restarts == 1
    assert resumed["start"] == 4 and len(resumed["losses"]) == 4
    [control] = runner.run(_kill_worker, str(tmp_path / "ctrl"), 8, {},
                           str(tmp_path / "b.json"))
    assert control["start"] == 0
    assert resumed["losses"] == control["losses"][4:]
    assert resumed["digest"] == control["digest"]

    counter = obs_counters.registry().counter("ft_corrupt_checkpoints")
    before = counter.value
    assert chaos.truncate_checkpoint(ck) == 8
    with AsyncCheckpointManager(ck) as mgr:
        with pytest.warns(UserWarning, match="corrupt"):
            state, rng, data = mgr.restore_full(_tiny_state(seed=3))
    assert state.step == 6 and rng == 42
    assert data == {"epoch": 0, "offset": 6}
    assert counter.value == before + 1
