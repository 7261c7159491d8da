"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source (`*.cu`) compiles with its own `nvcc` process, all started
together, for `sm_90a`; the objects link into one shared library under
`<repo>/build/kernels/`, named by a hash of the sources and the `*.cuh`
headers they include, so a changed source rebuilds and an unchanged one loads the existing library. The
library has a plain C interface and loads with `ctypes`. A missing
`nvcc` or a failed build raises: nothing falls back. The compiler's
output (`-Xptxas -v`: registers, spills, shared memory per kernel) is
kept beside the library as `<library>.log` and read back with it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LIB: ctypes.CDLL | None = None
build_log: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "propainter_corr_lookup": [_P] * 8 + [_I] * 8 + [_P, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _P],
    "propainter_deform_conv": [_P] * 7 + [_I] * 12 + [_P],
    "propainter_deform_conv_mma": [_P] * 6 + [_I] * 11 + [_P],
    "propainter_window_attention": [_P] * 12 + [_I] * 8 + [ctypes.c_float, _I, _P],
    "propainter_window_attention_tiled": [_P] * 16 + [_I] * 13 + [ctypes.c_float, _I, _P],
    "propainter_window_attention_halo": [_P] * 13 + [_I] * 11 + [ctypes.c_float, _I, _P],
    "propainter_corr_window": [_P] * 6 + [ctypes.c_longlong, _I, _I, _I, _P],
    "propainter_corr_window4": [_P] * 4 + [_I] * 8 + [_P] * 5 + [ctypes.c_longlong, _I, _P],
    "propainter_prop_fill": [_P] * 7 + [_I] * 9 + [_P],
    "propainter_corr_pyramid": [_P] * 10 + [_I] * 4 + [ctypes.c_float, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(sources: list[str]) -> str:
    """Hash of the sources and the headers they include."""
    h = hashlib.sha256()
    for s in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/*.cu into the shared library; returns its path and
    sets `build_log` to the compiler's output of that build."""
    global build_log
    sources = _sources()
    lib_path = os.path.join(BUILD_DIR, f"libpropainter_kernels_{_digest(sources)}.so")
    if os.path.exists(lib_path) and os.path.exists(lib_path + ".log"):
        with open(lib_path + ".log") as f:
            build_log = f.read()
        return lib_path
    nvcc = _nvcc()
    obj_dir = os.path.join(BUILD_DIR, f"obj-{os.getpid()}")  # private to this process
    os.makedirs(obj_dir, exist_ok=True)
    flags = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    procs = []
    for src in sources:
        obj = os.path.join(obj_dir, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *flags, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        objs.append(obj)
        if proc.returncode != 0:
            failed.append(src)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = lib_path + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", tmp, *objs], capture_output=True, text=True
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    with open(tmp + ".log", "w") as f:
        f.write(build_log)
    os.replace(tmp + ".log", lib_path + ".log")  # the log first: a library always has one
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
