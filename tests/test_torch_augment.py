"""The port's augmenter against tpudl's on the CPU: its numpy path and
its native kernel (the port's own copy of ``augment.cpp``, built by g++
into the checkout's ``build/``) against each other, and both against
tpudl's ``BatchAugmenter`` at the same seed (the same draws); the uint8
path and ``device_normalize`` against the host normalize. Tolerance:
atol 1e-6 (tests/test_augment.py's; both compute px * scale + bias in
f32)."""

import numpy as np
import pytest
import torch

from tpudl.data import augment as jaugment
from tpudl_torch.data import augment, native


def _images(seed, n=6, h=40, w=36, c=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, h, w, c)).astype(np.uint8)


@pytest.fixture(scope="module")
def built():
    if native.load_library() is None:
        pytest.fail(f"the native augmenter did not build: "
                    f"{native.last_error()}")
    return native.library_path()


def test_native_builds_into_the_build_directory(built):
    assert built.exists() and built.parent == native.BUILD_DIR
    assert built.parent.parent.name == "build"
    assert not list(native.SOURCE.parent.glob("*.so"))
    assert native.openmp() in (True, False)


def test_a_toolchain_without_openmp_builds_the_serial_kernel(monkeypatch,
                                                            tmp_path):
    """g++ without libgomp refuses -fopenmp ("cannot read spec file
    'libgomp.spec'"): the source builds without it and gives the same
    images."""
    cxx = tmp_path / "cxx"
    cxx.write_text(
        "#!/bin/sh\n"
        "for a in \"$@\"; do if [ \"$a\" = -fopenmp ]; then\n"
        "  echo \"g++: fatal error: cannot read spec file 'libgomp.spec'\" >&2\n"
        "  exit 1; fi; done\n"
        "exec g++ \"$@\"\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_openmp", None)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setenv("CXX", str(cxx))
    aug = augment.BatchAugmenter(backend="native", seed=2)
    assert native.openmp() is False
    images = _images(4)
    want = augment.BatchAugmenter(backend="numpy", seed=2)(images)
    np.testing.assert_allclose(aug(images), want, atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("mean,std", [
    (augment.CIFAR10_MEAN, augment.CIFAR10_STD),
    (augment.IMAGENET_MEAN, augment.IMAGENET_STD)])
def test_native_and_numpy_match_tpudl_at_the_same_seed(built, train, mean,
                                                       std):
    images = _images(1)
    kw = dict(crop=(32, 32), pad=4, mean=mean, std=std, seed=11, train=train)
    want = jaugment.BatchAugmenter(backend="numpy", **kw)
    outs = {b: augment.BatchAugmenter(backend=b, **kw)
            for b in ("native", "numpy")}
    assert outs["native"].backend == "native"
    assert outs["numpy"].backend == "numpy"
    for _ in range(2):  # the second call draws on from the same Generator
        ref = want({"image": images, "label": np.arange(6)})
        for b, aug in outs.items():
            got = aug({"image": images, "label": np.arange(6)})
            assert got["image"].dtype == np.float32
            assert got["image"].shape == (6, 32, 32, 3)
            np.testing.assert_allclose(got["image"], ref["image"], atol=1e-6,
                                       err_msg=b)
            np.testing.assert_array_equal(got["label"], np.arange(6))


def test_uint8_path_matches_tpudl_and_keeps_its_draws():
    images = _images(2)
    for train in (True, False):
        kw = dict(crop=(24, 24), pad=2, seed=4, normalize=False, train=train)
        got = augment.BatchAugmenter(backend="auto", **kw)(images)
        want = jaugment.BatchAugmenter(backend="numpy", **kw)(images)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    # Flips mirror columns; offsets stay within the padded frame.
    aug = augment.BatchAugmenter(crop=(40, 36), pad=0, seed=0,
                                 normalize=False)
    out = aug(images)
    for i in range(len(images)):
        assert (np.array_equal(out[i], images[i])
                or np.array_equal(out[i], images[i][:, ::-1]))


def test_device_normalize_matches_the_host_normalize():
    images = _images(3)
    batch = {"image": images, "label": np.arange(6)}
    kw = dict(crop=(32, 32), pad=4, seed=7, mean=augment.IMAGENET_MEAN,
              std=augment.IMAGENET_STD)
    host = augment.BatchAugmenter(backend="numpy", **kw)(dict(batch))
    raw = augment.BatchAugmenter(backend="numpy", normalize=False,
                                 **kw)(dict(batch))
    transform = augment.device_normalize(augment.IMAGENET_MEAN,
                                         augment.IMAGENET_STD)
    out = transform({k: torch.as_tensor(v) for k, v in raw.items()})
    assert out["image"].dtype == torch.float32
    np.testing.assert_allclose(out["image"].numpy(), host["image"], atol=1e-6)
    assert torch.equal(out["label"], torch.arange(6))


def test_refusals_and_a_failed_build(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="unknown backend"):
        augment.BatchAugmenter(backend="cuda")
    with pytest.raises(ValueError, match="uint8"):
        augment.BatchAugmenter(backend="numpy")(
            np.zeros((2, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="channels"):
        augment.BatchAugmenter(backend="numpy", mean=(0.5,), std=(0.5,))(
            np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(ValueError, match="larger than padded"):
        augment.BatchAugmenter(crop=(48, 48), pad=4, backend="numpy")(
            _images(0))
    # A compiler that is missing: "native" raises, "auto" takes numpy.
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="did not build"):
        augment.BatchAugmenter(backend="native")
    assert augment.BatchAugmenter(backend="auto").backend == "numpy"
