"""Build and load the port's hand-written CUDA kernels.

The sources under ``repro_torch/csrc`` have a plain C interface (no PyTorch
headers), so each compiles with ``nvcc`` in seconds.  At first use they are
compiled for Hopper (``sm_90a``) — one ``nvcc`` per source, all started
together — and linked into one shared library, which is loaded with
``ctypes``.  The library's file name carries a digest of the sources and
flags, so an edited source rebuilds and an unchanged tree reuses the build.

The build directory is ``src/repro_torch/_build`` (listed in ``.gitignore``).
Nothing here runs at import time: the CPU tests import every module, and
this machine may have neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("vsr.cu", "spmv.cu", "csc.cu", "sddmm.cu", "chain.cu",
           "attention.cu", "bsr.cu")
HEADERS = ("common.cuh", "score.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: argument types of every exported entry point (pointers and the stream as
#: c_void_p so ctypes does not cut them to 32 bits)
SIGNATURES = {
    "repro_vsr_spmm": (_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P),
    "repro_vsr_spmv": (_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _P),
    "repro_vsr_spmm_spill": (_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                             _I, _P),
    "repro_vsr_spmv_spill": (_P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                             _P),
    "repro_bsr_spmm": (_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                       _P),
    "repro_csc_spmm": (_P, _P, _I, _P, _I, _P, _I, _I, _I, _P),
    "repro_sddmm": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P),
    "repro_chain_stats": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _P),
    "repro_chain": (_P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                    _I, _F, _P),
    "repro_attn_stats": (_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _F, _P),
    "repro_attn": (_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                   _I, _F, _P),
    "repro_attn_stats_blocks": (_P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I,
                                _I, _I, _F, _P),
    "repro_attn_blocks": (_P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                          _I, _I, _I, _I, _F, _P),
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float       # 0.0 when an earlier build was reused
    log: str             # nvcc / ptxas output (registers, shared memory)


_LOCK = threading.Lock()
_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the port's CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildResult:
    """Compile the kernels into ``BUILD_DIR`` unless this exact tree was
    built already.  Raises ``RuntimeError`` with the compiler's output when a
    source does not compile."""
    lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if lib_path.exists():
        return BuildResult(lib_path, 0.0, "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs, failed = [], []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return BuildResult(lib_path, time.perf_counter() - t0, log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    with _LOCK:
        if "lib" not in _LOADED:
            handle = ctypes.CDLL(str(build().path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LOADED["lib"] = handle
        return _LOADED["lib"]


def check(err: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")
