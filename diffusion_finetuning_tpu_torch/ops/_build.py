"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints and the
stream), so it compiles in seconds without PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library is built at first use into ``build/torch_kernels/`` beside the
package (``DFT_TORCH_BUILD_DIR`` overrides it), keyed on a hash of the
sources, the headers and the flags, so an edited source rebuilds and an
unchanged one loads at once.  :func:`build` starts one ``nvcc`` per missing
library, all at the same time, and waits for every one of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("flash_attention", "flash_attention_bwd", "flash_attention_f32",
           "flash_attention_bwd_f32", "lora_matmul", "conv3x3")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("DFT_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "torch_kernels"


def nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS, verbose: bool = False) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, all in
    parallel.  Returns {name: compiler output} for the ones compiled
    (``verbose`` adds ``-Xptxas=-v``: registers, shared memory, spills per
    kernel).  Raises with the compiler's messages if any build fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
