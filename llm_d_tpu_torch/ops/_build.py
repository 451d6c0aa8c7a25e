"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all sources in parallel, into
``<repo>/build/llm_d_tpu_torch/<hash>/`` where the hash covers every
source, header and flag.  Libraries load with ``ctypes``.

Nothing here runs at import: the first CUDA launch of a wrapper (or an
explicit :func:`build_all`) builds, so importing any module of the port
needs neither ``nvcc`` nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "llm_d_tpu_torch"

SOURCES = ("mla_decode.cu", "mla_prefill.cu", "moe_dense_int8.cu",
           "moe_streamed_int8.cu", "paged_decode.cu", "flash_prefill.cu")
# Dynamic shared memory one block may use on the H100 (sm_90).
MAX_SMEM_PER_BLOCK = 232448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's kernels are built "
            "from llm_d_tpu_torch/csrc on first use")
    return found


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every missing library (one ``nvcc`` per source, all at
    once) and return ``{source: library path}``.  ``ptxas`` reports
    (registers, spills) land in ``<lib>.log`` beside each library."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src: out_dir / (pathlib.Path(src).stem + ".so")
            for src in SOURCES}
    todo = [src for src, lib in libs.items() if not lib.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs: List = []
    for src in todo:
        tmp = libs[src].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        libs[src].with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failures.append(f"{src}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, libs[src])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return libs


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source`` (built on first use)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[source]))
            lib.llmd_error_string.argtypes = [ctypes.c_int]
            lib.llmd_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


def launch(source: str, name: str, argtypes, *args) -> None:
    """Call launcher ``name`` of ``source``'s library with ``args`` (typed
    by ``argtypes``: pointers and the stream as ``c_void_p`` so ctypes
    never truncates them) and raise if it returned a CUDA error -- a
    refused launch never runs, and a later synchronize would not report
    it."""
    lib = load(source)
    fn = getattr(lib, name)           # ctypes caches the function object
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    code = fn(*args)
    if code != 0:
        msg = lib.llmd_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
