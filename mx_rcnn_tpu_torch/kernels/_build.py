"""Build the package's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` (CUDA, built with ``nvcc``) or ``csrc/<name>.cpp``
(host C++, built with the host compiler: ``$CXX``, else ``c++`` or
``g++``) exposes a plain C interface and is compiled on first use into
``mx_rcnn_tpu_torch/_build/<name>-<hash>.so`` (git-ignored), keyed on a
hash of the source and the compiler flags, so an edited source rebuilds
and an unchanged one loads from disk.  Nothing is compiled when a module
is imported: only a wrapper that is about to launch a kernel on a CUDA
tensor, or a host function of ``native.py`` that is called, calls
:func:`load`.

CUDA flags: ``sm_90a`` (Hopper), ``-O3`` and ``-fmad=false`` — the IoU of
the NMS and assign kernels must round exactly like the plain PyTorch
version, so no multiply-add may be contracted.  Host flags: ``-O3`` and
``-ffp-contract=off``, so the mask paste and the host NMS's IoU round
alike on every host (an aarch64 compiler would otherwise fuse their
products and sums).  Clear the
cache with ``rm -rf mx_rcnn_tpu_torch/_build``.
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
HOST_SOURCES = ("mxr_native",)
SOURCES = ("nms_bitmask", "assign_iou") + HOST_SOURCES
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-std=c++17", "-O3", "-ffp-contract=off", "-shared", "-fPIC")

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


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found ($CXX, c++ or g++): "
                       "mx_rcnn_tpu_torch/csrc/mxr_native.cpp is built from "
                       "source on first use")


def _source(name: str) -> Tuple[Path, Tuple[str, ...]]:
    """The source file of ``name`` and its compiler flags."""
    if name in HOST_SOURCES:
        return SRC_DIR / f"{name}.cpp", CXX_FLAGS
    return SRC_DIR / f"{name}.cu", NVCC_FLAGS


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source that has no up-to-date library yet, one
    compiler process per source, all started together.  Raises with the
    compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for name in names:
        so = library_path(name)
        out[name] = so
        if so.exists():
            continue
        src, flags = _source(name)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        compiler = _cxx() if name in HOST_SOURCES else _nvcc()
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for src, so, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building csrc/{src.name} failed "
                               f"(exit {proc.returncode}):\n{log.decode()}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
    return out


def load(name: str,
         signatures: Dict[str, Tuple[object, Sequence[object]]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built if needed, with
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
