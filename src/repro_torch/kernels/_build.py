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

A build *variant* compiles the same sources with extra defines into a
directory of its own: ``"poison_staging"`` (``-DREPRO_POISON_STAGING``)
fills the block design's shared-memory staging with NaN at CTA entry, so a
test can show that every entry the kernels read was written;
``"fault_launch"`` (``-DREPRO_FAULT_LAUNCH``) makes the launchers of the
main path's kernels (K1 in ``vsr.cu`` and ``spmv.cu``, K2, K3 in ``csc.cu``;
K4 shares K1's launcher) ask for an illegal block size, so each launch
fails with ``cudaErrorInvalidConfiguration`` — a real launch error, not
sticky, which ``check`` raises as a ``RuntimeError`` and the guardrails'
ladder counts (``kernel_failure:*``) before the call re-raises it.  ``with variant(name):`` makes the wrappers launch from
that library; outside it they launch from the default build.
"""
from __future__ import annotations

import contextlib
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
HEADERS = ("common.cuh", "score.cuh", "mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: build variants: name -> the extra nvcc flags ("" is the default build)
VARIANTS = {"": (), "poison_staging": ("-DREPRO_POISON_STAGING",),
            "fault_launch": ("-DREPRO_FAULT_LAUNCH",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: argument types of every exported entry point (pointers and the stream as
#: c_void_p so ctypes does not cut them to 32 bits)
SIGNATURES = {
    "repro_vsr_sr": (_P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    "repro_vsr_pr": (_P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _P),
    "repro_vsr_spmv": (_P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _P),
    "repro_vsr_spmm_spill": (_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                             _I, _I, _I, _P),
    "repro_spill_combine": (_P, _P, _P, _I, _I, _I, _I, _P),
    "repro_vsr_spmv_spill": (_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                             _I, _P),
    "repro_bsr_spmm": (_P, _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                       _P),
    "repro_bsr_spmm_tc": (_P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _I, _I, _I,
                          _I, _I, _P),
    "repro_csc_sr": (_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _P),
    "repro_csc_pr": (_P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _P),
    "repro_sddmm": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    "repro_chain_stats": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _F, _I,
                          _P),
    "repro_chain": (_P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                    _I, _I, _F, _P),
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
#: the variant ``lib()`` loads (``variant`` sets it)
_ACTIVE = {"variant": ""}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin); "
                           "the port's CUDA kernels cannot be built")
    return found


def _flags(variant: str) -> tuple:
    if variant not in VARIANTS:
        raise ValueError(f"unknown build variant {variant!r}; expected one of "
                         f"{sorted(VARIANTS)}")
    return NVCC_FLAGS + VARIANTS[variant]


def _digest(variant: str = "") -> str:
    h = hashlib.sha1(" ".join(_flags(variant)).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(variant: str = "") -> BuildResult:
    """Compile the kernels (with ``variant``'s flags, into a directory of
    its own) unless this exact tree was built already.  Raises
    ``RuntimeError`` with the compiler's output when a source does not
    compile."""
    flags = _flags(variant)
    out_dir = BUILD_DIR / variant if variant else BUILD_DIR
    lib_path = out_dir / f"librepro_torch_{_digest(variant)}.so"
    if lib_path.exists():
        return BuildResult(lib_path, 0.0, "")
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *flags, "-c", str(CSRC / src), "-o", str(obj)],
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
    """The loaded kernel library of the active variant, built on first
    use."""
    with _LOCK:
        name = _ACTIVE["variant"]
        if name not in _LOADED:
            handle = ctypes.CDLL(str(build(name).path))
            for fn_name, argtypes in SIGNATURES.items():
                fn = getattr(handle, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LOADED[name] = handle
        return _LOADED[name]


@contextlib.contextmanager
def variant(name: str):
    """Launch the kernels from build variant ``name`` inside the block
    (built on its first launch)."""
    _flags(name)
    previous = _ACTIVE["variant"]
    _ACTIVE["variant"] = name
    try:
        yield
    finally:
        _ACTIVE["variant"] = previous


def check(err: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")
