"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

nvcc compiles every source into one shared library with a plain C
interface for ``sm_90a`` (Hopper), into ``sslap_tpu_torch/_build/`` keyed
by a hash of the sources and flags, at first use; ctypes loads it.
Nothing here runs at import: a host without nvcc imports the package and
uses the kernels' plain twins on CPU tensors, and a CUDA tensor on such a
host raises from ``load()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
# What the last compile in this process reported (ptxas register and
# shared-memory use per kernel) and how long it took; None when the
# library came from the build cache.
build_log: Optional[str] = None
build_seconds: Optional[float] = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the CUDA "
            "kernels cannot be built on this host")
    return found


def _declare(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    for suffix, scalar in (("f32", ctypes.c_float), ("i32", ctypes.c_int32)):
        fn = getattr(lib, f"sslap_bid_{suffix}")
        fn.restype = ctypes.c_int
        # ids, C, cols, vals_m, nvalid, prices, sigma, owner, n, m, K,
        # eps, bigp, neg, half_neg, phase_start, tgt, bid, stream
        fn.argtypes = [p, i64, p, p, p, p, p, p, i32, i32, i32,
                       scalar, scalar, scalar, scalar, ctypes.c_int,
                       p, p, p]
        fn = getattr(lib, f"sslap_commit_{suffix}")
        fn.restype = ctypes.c_int
        # ids, tgt, bid, C, n, m, keys, prices, owner, sigma, stay,
        # evicted, counts, stream
        fn.argtypes = [p, p, p, i64, i32, i32, p, p, p, p, p, p, p, p]
    lib.sslap_error_string.restype = ctypes.c_char_p
    lib.sslap_error_string.argtypes = [ctypes.c_int]


def load() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    srcs = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(_CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    so = _BUILD / f"sslap_torch_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        t0 = time.perf_counter()
        out = subprocess.run([_nvcc(), *FLAGS, "-o", str(tmp),
                              *map(str, srcs)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed ({out.returncode}):\n"
                               f"{out.stderr[-4000:]}")
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
        build_log = out.stderr
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        text = _lib.sslap_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
