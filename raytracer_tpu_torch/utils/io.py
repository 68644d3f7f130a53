"""Image IO through the repository's native C++ writer (ctypes), with a
PIL fallback.

Counterpart of ``raytracer_tpu/utils/io.py``: ``quantise_unit``,
``save_image`` and ``save_apng`` over ``native/imageio.cpp`` (zlib PNG,
APNG and PPM writers, unit-float to u8 quantisation).  The library is built
with ``g++`` at first use into ``build/imageio-<hash>/`` at the repository
root (``.gitignore`` lists ``build/``), named by a hash of the source and
the flags.  Without a compiler, ``quantise_unit`` falls back to numpy and
the writers to PIL, as in the JAX package.  Host code only: nothing here
touches the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.native import BUILD_DIR

SOURCE = BUILD_DIR.parent / "native" / "imageio.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS)
                            .encode()).hexdigest()[:16]
    out = BUILD_DIR / f"imageio-{digest}" / "libimageio.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.parent / f"libimageio.so.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-lz", "-o",
                        str(tmp)], check=True, capture_output=True)
        os.replace(tmp, out)          # atomic: concurrent builders agree
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The native library, or None when it cannot be built or loaded."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.CalledProcessError):
        return None
    writer = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    for fn in (lib.write_png, lib.write_ppm):
        fn.argtypes, fn.restype = writer, ctypes.c_int
    lib.quantise_unit_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64]
    lib.quantise_unit_u8.restype = None
    lib.write_apng.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int]
    lib.write_apng.restype = ctypes.c_int
    _lib = lib
    return _lib


def quantise_unit(img: np.ndarray) -> np.ndarray:
    """``min(1, max(0, img)) * 255`` rounded half to even, as uint8."""
    img = np.ascontiguousarray(img, np.float32)
    lib = _load()
    out = np.empty(img.shape, np.uint8)
    if lib is not None:
        lib.quantise_unit_u8(img.ctypes.data_as(ctypes.c_void_p),
                             out.ctypes.data_as(ctypes.c_void_p), img.size)
        return out
    s = np.clip(img, 0.0, 1.0) * 255.0
    return np.asarray(np.round(s), np.uint8)


def save_image(path, rgb_u8: np.ndarray) -> None:
    """Write a ``[H, W, 3]`` uint8 image: PNG for a ``.png`` path, else PPM
    (native), with a PIL fallback."""
    path = str(path)
    rgb_u8 = np.ascontiguousarray(rgb_u8, np.uint8)
    if rgb_u8.ndim != 3 or rgb_u8.shape[-1] != 3:
        raise ValueError(f"expected [H, W, 3] u8, got {rgb_u8.shape}")
    h, w = rgb_u8.shape[:2]
    lib = _load()
    if lib is not None:
        fn = lib.write_png if path.endswith(".png") else lib.write_ppm
        if fn(path.encode(), rgb_u8.ctypes.data_as(ctypes.c_void_p),
              w, h) == 0:
            return
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("no native imageio and no PIL available")
    Image.fromarray(rgb_u8).save(path)


def save_apng(path, frames_u8: np.ndarray, fps: float = 10.0) -> None:
    """Write ``[F, H, W, 3]`` uint8 frames as an animated PNG (full-frame
    replace, infinite loop), native, with a PIL ``save_all`` fallback."""
    path = str(path)
    frames_u8 = np.ascontiguousarray(frames_u8, np.uint8)
    if frames_u8.ndim != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"expected [F,H,W,3] u8, got {frames_u8.shape}")
    f, h, w = frames_u8.shape[:3]
    delay_num, delay_den = 1, max(1, min(int(round(fps)), 30_000))
    lib = _load()
    if lib is not None:
        if lib.write_apng(path.encode(),
                          frames_u8.ctypes.data_as(ctypes.c_void_p),
                          w, h, f, delay_num, delay_den) == 0:
            return
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("no native imageio and no PIL available")
    imgs = [Image.fromarray(frames_u8[i]) for i in range(f)]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=1000.0 * delay_num / delay_den, loop=0)
