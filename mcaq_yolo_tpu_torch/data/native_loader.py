"""
ctypes binding of the port's native preprocessing library
`csrc/dataio.cpp` (port of `mcaq_yolo_tpu/data/native_loader.py:1-126`).

The library is built with g++ at first use (`ops/build.py`); a failed
build raises with the compiler's output.  The reference falls back to its
Python/cv2 letterbox when its library is not built; the port does not,
because without cv2 that fallback is a nearest-index resize that changes
the pixels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np

from ..ops import build

_lib = None
_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = build.load_library("dataio")
            u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
            lib.mcaq_letterbox_f32.restype = ctypes.c_float
            lib.mcaq_letterbox_f32.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float), i32p, i32p]
            lib.mcaq_letterbox_u8.restype = ctypes.c_float
            lib.mcaq_letterbox_u8.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint8,
                u8p, i32p, i32p]
            lib.mcaq_hflip_f32.restype = None
            lib.mcaq_hflip_f32.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            _lib = lib
    return _lib


def _image(img: np.ndarray) -> np.ndarray:
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an HxWx3 image, got shape {img.shape}")
    return np.ascontiguousarray(img, np.uint8)


def letterbox_f32(img: np.ndarray, out_size: int,
                  pad_value: float = 114.0) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Fused letterbox + normalize: HxWx3 uint8 -> (S, S, 3) float32 in [0, 1],
    in one pass over the image."""
    lib = _library()
    img = _image(img)
    h, w = img.shape[:2]
    out = np.empty((out_size, out_size, 3), np.float32)
    px, py = ctypes.c_int(), ctypes.c_int()
    scale = lib.mcaq_letterbox_f32(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, out_size,
        ctypes.c_float(pad_value), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(px), ctypes.byref(py))
    return out, float(scale), (px.value, py.value)


def letterbox_u8(img: np.ndarray, out_size: int,
                 pad_value: int = 114) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Letterbox keeping uint8 (normalization happens on the device):
    HxWx3 uint8 -> (S, S, 3) uint8; an input already S x S is copied."""
    lib = _library()
    img = _image(img)
    h, w = img.shape[:2]
    out = np.empty((out_size, out_size, 3), np.uint8)
    px, py = ctypes.c_int(), ctypes.c_int()
    scale = lib.mcaq_letterbox_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, out_size,
        ctypes.c_uint8(pad_value), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(px), ctypes.byref(py))
    return out, float(scale), (px.value, py.value)


def hflip_f32(img: np.ndarray) -> np.ndarray:
    """Horizontal flip of an (S, S, 3) float32 image (a contiguous copy,
    flipped in place)."""
    if img.ndim != 3 or img.shape[0] != img.shape[1] or img.shape[2] != 3:
        raise ValueError(f"expected an SxSx3 image, got shape {img.shape}")
    lib = _library()
    img = np.array(img, np.float32, order="C")
    lib.mcaq_hflip_f32(img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), img.shape[0])
    return img
