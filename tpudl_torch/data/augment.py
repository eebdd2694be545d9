"""Batch augmentation for the CV input pipeline: crop + flip + normalize.

The port's counterpart of tpudl.data.augment, with the same semantics and
the same draws: pad-and-random-crop + horizontal flip + per-channel
normalize over a uint8 NHWC batch, by the native C++ kernel
(tpudl_torch.data.native, a copy of tpudl's ``augment.cpp``) or by numpy.

All randomness (crop offsets, flip coins) is drawn HERE from one numpy
Generator, and both backends consume the same draws and the same f32
scale/bias formulation, so the backend never changes training beyond f32
rounding; at the same seed the draws are tpudl's own.

``device_normalize`` is the train step's ``input_transform`` for a uint8
batch (``BatchAugmenter(normalize=False)``): the host crops and flips
uint8 and ships 4x fewer bytes, the card computes ``px * scale + bias``
in f32.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from tpudl_torch.data import native

#: torchvision's ImageNet normalization (tpudl.data.augment's constants).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
#: Common CIFAR-10 statistics.
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)


def _scale_bias(mean, std):
    """px * scale + bias == (px/255 - mean)/std, in f32 like the kernel."""
    scale = np.float32(1.0) / (np.float32(255.0) * std)
    bias = -mean / std
    return scale.astype(np.float32), bias.astype(np.float32)


def _augment_numpy(images, pad, crop_h, crop_w, offsets, flip, mean, std,
                   normalize=True):
    n, h, w, c = images.shape
    padded = np.zeros((n, h + 2 * pad, w + 2 * pad, c), np.uint8)
    padded[:, pad: pad + h, pad: pad + w, :] = images
    out = np.empty(
        (n, crop_h, crop_w, c), np.float32 if normalize else np.uint8
    )
    for i in range(n):
        top, left = offsets[i]
        crop = padded[i, top: top + crop_h, left: left + crop_w, :]
        if flip[i]:
            crop = crop[:, ::-1, :]
        out[i] = crop
    if normalize:
        scale, bias = _scale_bias(mean, std)
        out *= scale
        out += bias
    return out


def _normalize_numpy(images, crop_h, crop_w, mean, std):
    n, h, w, c = images.shape
    scale, bias = _scale_bias(mean, std)
    top = (h - crop_h) // 2
    left = (w - crop_w) // 2
    out = images[:, top: top + crop_h, left: left + crop_w, :].astype(
        np.float32
    )
    out *= scale
    out += bias
    return out


def device_normalize(
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
    image_key: str = "image",
):
    """``(px/255 - mean)/std`` as a train or eval step's
    ``input_transform``: the batch's ``image_key`` column (uint8 NHWC on
    the device) becomes f32, by the host path's f32 arithmetic (the same
    ``_scale_bias``), so the two placements train alike."""
    scale, bias = _scale_bias(np.ascontiguousarray(mean, np.float32),
                              np.ascontiguousarray(std, np.float32))
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def transform(batch: Dict) -> Dict:
        x = batch[image_key]
        if x.device not in consts:
            consts[x.device] = (torch.from_numpy(scale).to(x.device),
                                torch.from_numpy(bias).to(x.device))
        s, b = consts[x.device]
        out = dict(batch)
        out[image_key] = x.float() * s + b
        return out

    return transform


def _ptr(array, ctype):
    return array.ctypes.data_as(ctypes.POINTER(ctype))


class BatchAugmenter:
    """Host-side training augmentation over a batch dict's image column
    (tpudl.data.augment.BatchAugmenter):

    - ``pad`` + random crop to ``crop`` (zero padding);
    - horizontal flip with probability 0.5 (``hflip=True``);
    - (px/255 - mean)/std normalization to f32 NHWC, or with
      ``normalize=False`` uint8 out (crop and flip by numpy slicing; pair
      with ``device_normalize``).

    ``backend``: "auto" uses the native kernel when it builds, else numpy;
    "native" requires it and raises when it does not build; "numpy"
    forces numpy. The normalizing kernel takes up to 16 channels (wider
    images take the numpy path); with ``normalize=False`` the native
    backend crops and flips any width in uint8 (``tpudl_crop_flip_u8``,
    bit for bit the numpy slicing). ``train=False`` center-crops.
    Call with a batch dict or a raw [N, H, W, C] uint8 array. Draws are
    lock-protected, so concurrent callers are safe.
    """

    def __init__(
        self,
        crop: Tuple[int, int] = (32, 32),
        pad: int = 4,
        hflip: bool = True,
        mean: Sequence[float] = CIFAR10_MEAN,
        std: Sequence[float] = CIFAR10_STD,
        image_key: str = "image",
        seed: int = 0,
        train: bool = True,
        backend: str = "auto",
        normalize: bool = True,
    ):
        self.crop = tuple(crop)
        self.pad = int(pad)
        self.hflip = hflip
        self.image_key = image_key
        self.train = train
        self.normalize = normalize
        self._rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()
        self._mean = np.ascontiguousarray(mean, np.float32)
        self._std = np.ascontiguousarray(std, np.float32)
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"unknown backend {backend!r}")
        self._lib = None
        if backend in ("auto", "native"):
            self._lib = native.load_library()
            if self._lib is None and backend == "native":
                raise RuntimeError(
                    f"backend='native' but the C++ kernel did not build or "
                    f"load: {native.last_error()}")

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "numpy"

    def __call__(self, batch):
        if isinstance(batch, dict):
            out = dict(batch)
            out[self.image_key] = self._images(batch[self.image_key])
            return out
        return self._images(batch)

    def _images(self, images: np.ndarray) -> np.ndarray:
        images = np.ascontiguousarray(images)
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(
                f"expected uint8 [N,H,W,C] images, got {images.dtype} "
                f"{images.shape}"
            )
        n, h, w, c = images.shape
        ch, cw = self.crop
        if self.normalize and len(self._mean) != c:
            raise ValueError(
                f"mean/std have {len(self._mean)} channels, images have {c}"
            )
        if not self.train:
            return self._center(
                images, self._lib if c <= 16 and self.normalize else None)
        max_top = h + 2 * self.pad - ch
        max_left = w + 2 * self.pad - cw
        if max_top < 0 or max_left < 0:
            raise ValueError(
                f"crop {self.crop} larger than padded image "
                f"({h + 2 * self.pad}, {w + 2 * self.pad})"
            )
        with self._rng_lock:
            offsets = np.stack(
                [self._rng.integers(0, max_top + 1, n),
                 self._rng.integers(0, max_left + 1, n)],
                axis=1,
            ).astype(np.int32)
            flip = (
                self._rng.random(n) < 0.5 if self.hflip else np.zeros(n, bool)
            ).astype(np.uint8)
        lib = self._lib if c <= 16 or not self.normalize else None
        if lib is None:
            return _augment_numpy(
                images, self.pad, ch, cw, offsets, flip, self._mean,
                self._std, normalize=self.normalize,
            )
        if not self.normalize:
            out = np.empty((n, ch, cw, c), np.uint8)
            lib.tpudl_crop_flip_u8(
                _ptr(images, ctypes.c_uint8), n, h, w, c, self.pad, ch, cw,
                _ptr(offsets, ctypes.c_int32), _ptr(flip, ctypes.c_uint8),
                _ptr(out, ctypes.c_uint8),
            )
            return out
        out = np.empty((n, ch, cw, c), np.float32)
        lib.tpudl_augment_batch(
            _ptr(images, ctypes.c_uint8), n, h, w, c, self.pad, ch, cw,
            _ptr(offsets, ctypes.c_int32), _ptr(flip, ctypes.c_uint8),
            _ptr(self._mean, ctypes.c_float), _ptr(self._std, ctypes.c_float),
            _ptr(out, ctypes.c_float),
        )
        return out

    def _center(self, images: np.ndarray, lib) -> np.ndarray:
        n, h, w, c = images.shape
        ch, cw = self.crop
        if ch > h or cw > w:
            raise ValueError(f"center crop {self.crop} larger than ({h}, {w})")
        if not self.normalize:
            top = (h - ch) // 2
            left = (w - cw) // 2
            return np.ascontiguousarray(
                images[:, top: top + ch, left: left + cw, :]
            )
        if lib is None:
            return _normalize_numpy(images, ch, cw, self._mean, self._std)
        out = np.empty((n, ch, cw, c), np.float32)
        lib.tpudl_normalize_batch(
            _ptr(images, ctypes.c_uint8), n, h, w, c, ch, cw,
            _ptr(self._mean, ctypes.c_float), _ptr(self._std, ctypes.c_float),
            _ptr(out, ctypes.c_float),
        )
        return out
