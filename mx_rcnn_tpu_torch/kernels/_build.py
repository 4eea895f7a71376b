"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``mx_rcnn_tpu_torch/_build/<name>-<hash>.so`` (git-ignored),
keyed on a hash of the source and the compiler flags, so an edited source
rebuilds and an unchanged one loads from disk.  Nothing is compiled when a
module is imported: only a wrapper that is about to launch a kernel on a
CUDA tensor calls :func:`load`.

Flags: ``sm_90a`` (Hopper), ``-O3`` and ``-fmad=false`` — the IoU of the
NMS and assign kernels must round exactly like the plain PyTorch version,
so no multiply-add may be contracted.  Clear the cache with
``rm -rf mx_rcnn_tpu_torch/_build``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("nms_bitmask", "assign_iou")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of mx_rcnn_tpu_torch "
                       "are built from source on first use and need the "
                       "CUDA toolkit (nvcc on PATH or /usr/local/cuda)")


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source that has no up-to-date library yet, one
    ``nvcc`` process per source, all started together.  Raises with the
    compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for name in names:
        so = library_path(name)
        out[name] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log.decode()}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    return out


def load(name: str,
         signatures: Dict[str, Tuple[object, Sequence[object]]]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed, with
    ``restype``/``argtypes`` set from ``signatures`` ({fn: (restype,
    [argtypes])}).  Pointers and streams must be ``ctypes.c_void_p``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = list(argtypes)
            _loaded[name] = lib
        return lib
