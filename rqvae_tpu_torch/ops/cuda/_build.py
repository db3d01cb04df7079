"""Build the CUDA C++ kernels (rqvae_tpu_torch/csrc/*.cu) and load them.

Each source is compiled at first use by `nvcc` for Hopper (sm_90a) into a
shared library with a plain C interface, placed in rqvae_tpu_torch/_build/
(named by a hash of the source and of every csrc/ header it includes, so an
edited source or header rebuilds), and loaded with ctypes. Pointers and the stream cross the boundary as c_void_p.
`build_all()` starts one nvcc per source at once, for callers that want
every kernel built up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("rq_encode", "decoder_stack", "attention", "encoder_stack", "attention_bwd")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
]
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def source_files(name: str) -> List[Path]:
    """csrc/<name>.cu and every file under csrc/ it includes with quotes,
    directly or through another such header, in a fixed order."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            header = (CSRC / inc).resolve()
            if not header.is_file() or CSRC.resolve() not in header.parents:
                raise RuntimeError(f"{path.name} includes \"{inc}\", which is not a file under {CSRC}")
            todo.append(CSRC / inc)
    return [seen[0], *sorted(seen[1:])]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _log_path(lib: Path) -> Path:
    """The compiler log kept beside a built library (ptxas register, spill
    and shared-memory use of every kernel in it)."""
    return lib.with_suffix(".log")


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library and its compiler log are already built."""
    out = _lib_path(name)
    if out.exists() and _log_path(out).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    log_tmp = _log_path(tmp)
    log_tmp.write_text(log)
    os.replace(log_tmp, _log_path(out))  # the log first: a library on disk always has its log
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return log


def build_all() -> Dict[str, str]:
    """Build every kernel library, one nvcc per source, all at once.
    Returns each source's compiler log (ptxas register, spill and
    shared-memory use), read back from beside the library when it was
    already built."""
    jobs = {name: _start_build(name) for name in SOURCES}
    return {name: _finish_build(name, job) if job else _log_path(_lib_path(name)).read_text()
            for name, job in jobs.items()}


def load_library(name: str, functions: Dict[str, List]) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use, with
    argtypes declared for `functions` (every function returns an int:
    the cudaError_t of its launch)."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in functions.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def aligned16(t):
    """t, or a copy of it in a fresh allocation when its data does not start
    on a 16-byte boundary (a view at an odd offset): the kernels read their
    operands 16 bytes at a time."""
    return t.clone() if t.data_ptr() % 16 else t


def launch_operand(t):
    """t as a kernel reads it: contiguous and starting on a 16-byte boundary.
    A strided view or one at an odd offset becomes a copy; any other tensor
    is returned as it is. The wrappers call it on every operand, as the
    reference computes on arrays of any layout."""
    return aligned16(t.contiguous())


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError != 0)."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
