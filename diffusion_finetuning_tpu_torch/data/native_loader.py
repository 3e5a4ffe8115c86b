"""ctypes bindings for the native C++ data-loader (the JAX package's
``data/native_loader.py``, with the library built into the port's build
directory).

``native/dataloader.cpp`` does multithreaded JPEG/PNG decode + bilinear
short-side resize + center crop + [-1,1] normalize + h-flip, assembling
NHWC float32 batches off the GIL (the counterpart of the reference's torch
DataLoader + torchvision C++ transform kernels, dataset.py:126-139).

Build: at first use, ``g++`` compiles the source with the flags of
``native/Makefile`` into ``build/torch_kernels/`` beside the package (where
``ops/_build.py`` builds the CUDA kernels; ``DFT_TORCH_BUILD_DIR``
overrides it), never into ``native/``.  The library's name carries a hash
of the source and of the host's CPU flags: it is built ``-march=native``,
so another host builds its own.  All entry points degrade gracefully:
``available()`` is False when the library cannot be built or loaded (no
compiler, no ``jpeglib.h``/``png.h``), and callers read through PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..ops._build import build_dir

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dataloader.cpp"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
LDLIBS = ("-ljpeg", "-lpng", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the library is not available (the compiler's first error), or None
unavailable_reason: Optional[str] = None


def _cpu_fingerprint() -> str:
    """Boot-time CPU feature fingerprint."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:8]
    except OSError:
        pass
    import platform

    return hashlib.sha1(platform.processor().encode()).hexdigest()[:8]


def library_path() -> Path:
    """Where the library for this source and this host is (or would be)."""
    h = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXXFLAGS + LDLIBS).encode())
    return build_dir() / f"libdft_dataloader-{h.hexdigest()[:12]}-{_cpu_fingerprint()}.so"


def _build() -> Optional[Path]:
    """The library, compiled first if it is missing; None if it cannot be."""
    global unavailable_reason
    if not SOURCE.exists():
        unavailable_reason = f"{SOURCE} is missing"
        return None
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE), *LDLIBS],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    except Exception as e:
        tmp.unlink(missing_ok=True)
        lines = (getattr(e, "stderr", b"") or b"").decode(errors="replace").splitlines()
        errors = [ln.strip() for ln in lines if "error" in ln] or [ln.strip() for ln in lines]
        unavailable_reason = errors[0] if errors else repr(e)
        return None
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        # DFT_NATIVE_LOADER=0 disables the native path entirely (callers
        # fall back to PIL)
        if os.environ.get("DFT_NATIVE_LOADER", "1") == "0":
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            global unavailable_reason
            unavailable_reason = str(e)
            return None
        lib.dft_version.restype = ctypes.c_int
        lib.dft_load_one.restype = ctypes.c_int
        lib.dft_load_one.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.dft_load_batch.restype = ctypes.c_int
        lib.dft_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        if lib.dft_version() != 1:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_image(path: str, size: int, flip: bool = False) -> Optional[np.ndarray]:
    """(size, size, 3) float32 in [-1, 1], or None on failure."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.float32)
    rc = lib.dft_load_one(
        path.encode(), size, int(flip),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out if rc == 0 else None


def load_batch(
    paths: Sequence[str], size: int, flips: Optional[Sequence[bool]] = None,
    n_threads: int = 0,
) -> Optional[np.ndarray]:
    """(N, size, size, 3) float32 batch decoded in a native thread pool."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size, 3), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_flips = (ctypes.c_int * n)(*[int(bool(f)) for f in (flips or [0] * n)])
    rc = lib.dft_load_batch(
        c_paths, n, size, c_flips,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
    )
    return out if rc == 0 else None
