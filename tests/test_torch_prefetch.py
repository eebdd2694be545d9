"""The port's two-stage prefetcher (tpudl_torch.data.prefetch) against
tpudl's (tpudl.data.prefetch) on the CPU: the same numpy source and
transform give the same batch sequence at any worker count, a worker's
exception wins the very next pull, ``close()`` and an early ``break``
reap every thread, the autotuner decides alike on a scripted wait
sequence, and the mesh and window feeds are refused. The transfer stage's
pinned copy on a side stream runs on the card (chip_smoke.py's
resnet50_train phase)."""

import threading
import time

import numpy as np
import pytest
import torch

from tpudl.data import prefetch as jprefetch
from tpudl_torch.data import prefetch as tprefetch
from tpudl_torch.data.augment import BatchAugmenter

_PREFIX = "tpudl-torch-prefetch"


def _alive():
    return [t for t in threading.enumerate()
            if t.name.startswith(_PREFIX) and t.is_alive()]


def _reaped(timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _alive():
            return True
        time.sleep(0.01)
    return False


def _source(n, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        yield {"image": rng.integers(0, 256, (4, 10, 9, 3), np.uint8),
               "label": np.full((4,), i, np.int64)}


def _jittery_augment(batch):
    """A transform that is a function of its batch alone (a per-batch
    seed), with uneven latency that scrambles completion order."""
    i = int(batch["label"][0])
    time.sleep(0.001 * (i % 3))
    aug = BatchAugmenter(crop=(8, 8), pad=2, normalize=False, seed=i,
                         backend="numpy")
    return aug(batch)


@pytest.mark.parametrize("workers", [1, 4])
def test_same_batch_sequence_as_tpudl(workers):
    got = list(tprefetch.prefetch_to_device(
        _source(12), transform=_jittery_augment, assembly_workers=workers,
        device="cpu"))
    want = list(jprefetch.prefetch_to_device(
        _source(12), transform=_jittery_augment, assembly_workers=workers))
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    assert _reaped()


def test_worker_exception_wins_the_next_pull():
    def bad():
        for i in range(3):
            yield {"x": np.full((2,), i, np.float32)}
        raise RuntimeError("reader exploded")

    for module, kw in ((tprefetch, {"device": "cpu"}), (jprefetch, {})):
        it = module.prefetch_to_device(bad(), prefetch=8, **kw)
        deadline = time.monotonic() + 5.0
        while it._p.error is None and time.monotonic() < deadline:
            time.sleep(0.005)
        assert it._p.error is not None
        # Three good batches are queued ahead of the failure.
        with pytest.raises(RuntimeError, match="reader exploded"):
            next(it)
    assert _reaped()
    leaky = tprefetch.prefetch_to_device(
        _source(2), device="cpu", transform=lambda b: next(iter(())))
    with pytest.raises(RuntimeError, match="StopIteration"):
        list(leaky)
    assert _reaped()


def test_close_and_early_break_reap_every_thread():
    def infinite():
        i = 0
        while True:
            yield {"x": np.full((4,), i, np.int32)}
            i += 1

    it = tprefetch.prefetch_to_device(infinite(), prefetch=2,
                                      assembly_workers=3, device="cpu")
    assert int(next(it)["x"][0]) == 0
    assert len(_alive()) == 4  # three assembly workers + the transfer
    it.close()
    assert _reaped(), "prefetch workers leaked after close"
    with pytest.raises(StopIteration):
        next(it)
    it.close()  # idempotent
    with tprefetch.prefetch_to_device(infinite(), assembly_workers=2,
                                      device="cpu") as it:
        for n, _ in enumerate(it):
            if n >= 3:
                break
    assert _reaped()
    it = tprefetch.prefetch_to_device(infinite(), assembly_workers=2,
                                      device="cpu")
    next(it)
    del it  # abandoned: the finalizer reaps
    import gc

    deadline = time.monotonic() + 5.0
    while _alive() and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert not _alive(), "abandoned prefetcher leaked"


def test_autotuner_decides_like_tpudls():
    """A scripted wait sequence: starved, fed, starved past the byte
    budget; the same depths and decisions from both."""
    waits = [9.9] + [0.05] * 12 + [0.001] * 8 + [0.03] * 16
    sizes = [1000] * 29 + [5000] * 8
    kw = dict(depth=2, max_depth=8, target_wait_s=0.01, window=4,
              byte_budget=24000)
    mine, theirs = tprefetch.PrefetchAutotuner(**kw), \
        jprefetch.PrefetchAutotuner(**kw)
    for w, n in zip(waits, sizes):
        assert mine.observe(w, n) == theirs.observe(w, n)
    # Three windows starved (2 -> 5), two fed, two more grows at 1000 B
    # a batch, none at 5000 (8 x 5000 > 24000).
    assert mine.decisions == theirs.decisions and mine.depth == 7
    with pytest.raises(ValueError):
        tprefetch.PrefetchAutotuner(depth=4, max_depth=2)


def test_env_depth_pins_the_depth(monkeypatch):
    monkeypatch.setenv("TPUDL_PREFETCH_DEPTH", "5")
    it = tprefetch.prefetch_to_device(_source(3), prefetch=2, device="cpu")
    assert it.depth == 5 and it._autotuner is None
    assert len(list(it)) == 3 and len(it.waits) == 3


def test_mesh_and_window_refused():
    with pytest.raises(NotImplementedError, match="queue A item 7"):
        tprefetch.prefetch_to_device(_source(1), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        tprefetch.prefetch_to_device(_source(1), window=4, device="cpu")
    with pytest.raises(ValueError, match="assembly_workers"):
        tprefetch.prefetch_to_device(_source(1), assembly_workers=0,
                                     device="cpu")
    assert _reaped()


@pytest.mark.parametrize("pad,crop", [(0, (32, 32)), (3, (40, 37)),
                                      (8, (24, 30))])
def test_native_uint8_crop_flip_is_the_numpy_slicing(pad, crop):
    """``normalize=False`` on the native backend (tpudl_crop_flip_u8,
    called through ctypes, which releases the interpreter lock) gives
    the numpy path's bytes, at the same draws."""
    images = np.random.default_rng(0).integers(0, 256, (16, 40, 37, 3),
                                               np.uint8)
    native = BatchAugmenter(crop=crop, pad=pad, normalize=False, seed=3,
                            backend="native")
    numpy_ = BatchAugmenter(crop=crop, pad=pad, normalize=False, seed=3,
                            backend="numpy")
    got, want = native(images), numpy_(images)
    assert got.dtype == np.uint8 and got.shape == (16, *crop, 3)
    np.testing.assert_array_equal(got, want)
