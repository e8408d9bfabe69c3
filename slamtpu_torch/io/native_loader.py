"""ctypes bindings for the native C++ frame loader
(counterpart of slamtpu/io/native_loader.py, over the same
native/frame_loader.cpp, which is read and never edited).

The native library decodes PGM/PNG frames with a pthread worker pool,
prefetching ahead of the consumer; it needs zlib and no image library, so
it is how frames reach the pipeline on a machine without cv2 or PIL. It is
built at first use with

    g++ -O3 -fPIC -std=c++17 -shared -o build/slamtpu_torch/libframe_loader-<hash>.so
        native/frame_loader.cpp -lz -lpthread

where <hash> covers the source and the flags, so an edited source is
rebuilt and a stale library never loaded. Each build writes a file of its
own and moves it into place with os.replace, so processes that build at
once each load a whole library. When the library cannot be built, a load
raises with the compiler's error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from .._build import BUILD_DIR

__all__ = ["NativeFrameLoader", "native_available", "load_frames_native"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "frame_loader.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lz", "-lpthread")

_lib = None


def _lib_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libframe_loader-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library's path, compiled first if it is missing; raises
    RuntimeError with the compiler's output when g++ or zlib is missing."""
    if not SOURCE.exists():
        raise RuntimeError(f"native frame loader source missing: {SOURCE}")
    path = _lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native frame loader: cannot run g++ ({e})") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native frame loader: g++ failed:\n{out.stderr}")
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        lib.loader_open.restype = ctypes.c_void_p
        lib.loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.loader_frame_size.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
        lib.loader_next.restype = ctypes.c_int
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def native_available() -> bool:
    """True when the library is built or can be built here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


class NativeFrameLoader:
    """Streaming chunk reader over a list of image paths.

    with NativeFrameLoader(paths, threads=4, prefetch=32) as loader:
        for chunk in loader.chunks(32):  # [<=32, H, W] uint8
            ...
    """

    def __init__(
        self,
        paths: List[str],
        out_size: Optional[tuple] = None,
        threads: int = 4,
        prefetch: int = 32,
    ):
        self._handle = None
        lib = _load()
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        oh, ow = out_size or (0, 0)
        self._handle = lib.loader_open(arr, len(paths), oh, ow, threads, prefetch)
        h = ctypes.c_int()
        w = ctypes.c_int()
        lib.loader_frame_size(self._handle, ctypes.byref(h), ctypes.byref(w))
        self.height, self.width = h.value, w.value
        if self.height == 0:
            self.close()
            raise ValueError("could not decode the first frame")

    def read(self, max_frames: int) -> np.ndarray:
        out = np.empty((max_frames, self.height, self.width), np.uint8)
        got = self._lib.loader_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_frames
        )
        return out[:got]

    def chunks(self, chunk_size: int):
        while True:
            block = self.read(chunk_size)
            if block.shape[0] == 0:
                return
            yield block

    def close(self):
        if self._handle:
            self._lib.loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def load_frames_native(directory: str, max_frames: Optional[int] = None,
                       threads: int = 4) -> np.ndarray:
    """Load a whole image directory (sorted PNG and PGM files) through the
    native loader."""
    names = sorted(
        f for f in os.listdir(directory) if f.lower().endswith((".png", ".pgm"))
    )
    if max_frames:
        names = names[:max_frames]
    paths = [os.path.join(directory, n) for n in names]
    with NativeFrameLoader(paths, threads=threads) as loader:
        return loader.read(len(paths))
