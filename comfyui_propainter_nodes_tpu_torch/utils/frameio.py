"""Video frames from a .npy file: the native mmap reader with a prefetch
thread (`native/frameio.cpp`, loaded with ctypes).

The library is built at first use with `g++ -O3 -fPIC -shared -pthread
-std=c++17` into `<repo>/build/frameio/`, named by a hash of the source,
so a changed source rebuilds and an unchanged one loads the existing
library. Nothing falls back: a failed build raises, and so does a file
the reader does not take (it takes a C-order [T, H, W, C] array of
uint8 or little-endian float32).

`read_frames_plain` is the reader's plain NumPy version, with the same
semantics, kept for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "frameio.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "frameio")
TAKES = "a C-order [T, H, W, C] .npy of uint8 or little-endian float32"

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


def build() -> str:
    """Compile native/frameio.cpp (unless the library of this source
    exists); returns the library's path. Raises when g++ is missing or
    fails."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libframeio_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the frame reader native/frameio.cpp cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp{os.getpid()}"
    proc = subprocess.run(
        [cxx, "-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", SOURCE, "-o", tmp],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded reader library (built on first call)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.fio_open.restype = ctypes.c_void_p
            lib.fio_open.argtypes = [ctypes.c_char_p]
            lib.fio_info.restype = None
            lib.fio_info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)]
            lib.fio_fetch_f32.restype = None
            lib.fio_fetch_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
            ]
            lib.fio_prefetch.restype = None
            lib.fio_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
            lib.fio_close.restype = None
            lib.fio_close.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def _check_header(path: str) -> None:
    """Raise ValueError for a .npy the native reader does not take."""
    with open(path, "rb") as f:
        fmt = np.lib.format
        read = fmt.read_array_header_1_0 if fmt.read_magic(f) == (1, 0) else fmt.read_array_header_2_0
        shape, fortran_order, dtype = read(f)
    if fortran_order or len(shape) != 4 or dtype not in (np.dtype(np.uint8), np.dtype("<f4")):
        raise ValueError(
            f"{path}: shape {shape}, dtype {dtype}, fortran_order {fortran_order}; the frame reader takes {TAKES}"
        )


class VideoSource:
    """Random-access frames of a .npy video [T, H, W, C] through the
    native reader: `fetch` returns float32 in [0, 1] (uint8 scaled by
    1/255, float32 as stored), clamping indices into [0, T) (the last
    frame repeats past the end); `prefetch` hints the frames to page in
    next. Close it (or use it as a context manager) to stop its thread."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        _check_header(path)
        lib = library()
        handle = lib.fio_open(os.fsencode(path))
        if not handle:
            raise ValueError(f"{path}: the native reader rejected it; it takes {TAKES}")
        self._handle = ctypes.c_void_p(handle)
        dims = (ctypes.c_int64 * 4)()
        dtype = ctypes.c_int()
        lib.fio_info(self._handle, dims, ctypes.byref(dtype))
        self.shape = tuple(int(d) for d in dims)

    @property
    def num_frames(self) -> int:
        return self.shape[0]

    def _live(self) -> ctypes.c_void_p:
        if self._handle is None:
            raise ValueError(f"{self.path}: the source is closed")
        return self._handle

    def prefetch(self, start: int, count: int) -> None:
        library().fio_prefetch(self._live(), start, count)

    def fetch(self, start: int, count: int) -> np.ndarray:
        """float32 frames [count, H, W, C] in [0, 1]: frame start + i,
        clamped into [0, T)."""
        _, h, w, c = self.shape
        out = np.empty((count, h, w, c), np.float32)
        library().fio_fetch_f32(self._live(), start, count, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def close(self) -> None:
        if self._handle is not None:
            library().fio_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_frames_plain(path: str, start: int, count: int) -> np.ndarray:
    """`VideoSource.fetch` in NumPy: frames start .. start + count - 1,
    clamped into [0, T), as float32 in [0, 1] (uint8 divided by 255)."""
    arr = np.load(path, mmap_mode="r")
    idx = np.clip(np.arange(start, start + count), 0, arr.shape[0] - 1)
    out = np.asarray(arr[idx], np.float32)
    if arr.dtype == np.uint8:
        out /= 255.0
    return out
