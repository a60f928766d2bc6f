"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

nvcc compiles each source to an object for ``sm_90a`` (Hopper), one
process per source, all started together, then links them into one shared
library with a plain C interface, in ``sslap_tpu_torch/_build/`` keyed by
a hash of the sources and flags, at first use; ctypes loads it.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
         "-Xcompiler", "-fPIC")

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
    c_int = ctypes.c_int
    for suffix, scalar in (("f32", ctypes.c_float), ("i32", ctypes.c_int32)):
        fn = getattr(lib, f"sslap_bid_{suffix}")
        fn.restype = ctypes.c_int
        # ids, C, cols, vals_m, nvalid, prices, sigma, owner, n, m, K,
        # eps, bigp, neg, half_neg, phase_start, lanes, vec, tgt, bid,
        # stream
        fn.argtypes = [p, i64, p, p, p, p, p, p, i32, i32, i32,
                       scalar, scalar, scalar, scalar, c_int, c_int, c_int,
                       p, p, p]
        fn = getattr(lib, f"sslap_bid_batched_{suffix}")
        fn.restype = ctypes.c_int
        # ids, C, cols, vals_m, nvalid, prices, sigma, owner, n, m, K,
        # eps_of, bigp_of, rows_per, neg, half_neg, phase_start, lanes,
        # vec, tgt, bid, stream
        fn.argtypes = [p, i64, p, p, p, p, p, p, i32, i32, i32, p, p, i32,
                       scalar, scalar, c_int, c_int, c_int, p, p, p]
        fn = getattr(lib, f"sslap_dense_bid_{suffix}")
        fn.restype = ctypes.c_int
        # ids, C, A, nvalid, prices, sigma, eps_of, bigp, neg, n, m, rows,
        # no_bid, vec, tgt, bid, v1_out, stream
        fn.argtypes = [p, i64, p, p, p, p, p, scalar, scalar, i32, i32, i32,
                       i32, ctypes.c_int, p, p, p, p]
        fn = getattr(lib, f"sslap_commit_{suffix}")
        fn.restype = ctypes.c_int
        # ids, tgt, bid, C, n_rows, m, keys, prices, owner, sigma,
        # row_offset, n_local, stay, evicted, counts, stream
        fn.argtypes = [p, p, p, i64, i32, i32, p, p, p, p, i32, i32, p, p,
                       p, p]
        fn = getattr(lib, f"sslap_resolve_{suffix}")
        fn.restype = ctypes.c_int
        # ids, tgt, bid, C, m, keys, stream
        fn.argtypes = [p, p, p, i64, i32, p, p]
        fn = getattr(lib, f"sslap_commit_keys_{suffix}")
        fn.restype = ctypes.c_int
        # keys, m, prices, owner, sigma, n_local, row_offset, eps, half_neg,
        # guarded, stream
        fn.argtypes = [p, i32, p, p, p, i32, i32, scalar, scalar, c_int, p]
        fn = getattr(lib, f"sslap_ladder_{suffix}")
        fn.restype = ctypes.c_int
        # cols, vals_m, nvalid, prices, owner, sigma, keys, ids0, ids1,
        # tgt, bid, ctrl, tiers, ntiers, n, m, K, eps, bigp, neg,
        # half_neg, first, wide, threshold, rounds, max_iter, out, stream
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, p, i32, i32, i32,
                       i32, scalar, scalar, scalar, scalar, ctypes.c_int,
                       ctypes.c_int, i32, i64, i64, p, p]
    lib.sslap_ladder_blocks.restype = ctypes.c_int
    lib.sslap_ladder_blocks.argtypes = []
    lib.sslap_ladder_ctrl_bytes.restype = ctypes.c_int
    lib.sslap_ladder_ctrl_bytes.argtypes = []
    lib.sslap_gs_f32.restype = ctypes.c_int
    # cols, vals, K, queue, cap, qcount, prices, owner, m, packed, eps,
    # bigp, neg, half, real_min, max_bids, bid_warps, scan, stats, stream
    f32 = ctypes.c_float
    lib.sslap_gs_f32.argtypes = [p, p, i32, p, i64, i64, p, p, i64, p, f32,
                                 f32, f32, f32, f32, i64, c_int, c_int, p, p]
    lib.sslap_gs_smem.restype = ctypes.c_longlong
    lib.sslap_gs_smem.argtypes = [i32, c_int]
    # P1-P3: src, row, off, scratch_rows, out, stream
    lib.sslap_probe_copy.restype = c_int
    lib.sslap_probe_copy.argtypes = [p, i64, i32, i32, p, p]
    # P4-P5: table, idx, widx, out, stream
    lib.sslap_probe_lane.restype = c_int
    lib.sslap_probe_lane.argtypes = [p, i64, i64, p, p]
    # P7, P8, P10-P12, P14: variant, hbm, vbm, q, pt, ot, n, limit, seg,
    # blocks, out, stream
    lib.sslap_probe_queue.restype = c_int
    lib.sslap_probe_queue.argtypes = [c_int, p, p, p, p, p, i32, i32, i32,
                                      c_int, p, p]
    # P13, P15: hbm, q, n, limit, seg, blocks, scratch, arrived, out, stream
    lib.sslap_probe_store.restype = c_int
    lib.sslap_probe_store.argtypes = [p, p, i32, i32, i32, c_int, p, p, p, p]
    # P6, P9: hbm, n, blocks, out, stream
    lib.sslap_probe_pump.restype = c_int
    lib.sslap_probe_pump.argtypes = [p, i32, c_int, p, p]
    # P16-P17: stage, clines, vlines, K, q, price bits, o, qcount,
    # max_bids, cap, gather_warps, stats, acc, counters, stream
    lib.sslap_probe_ladder.restype = c_int
    lib.sslap_probe_ladder.argtypes = [c_int, p, p, i32, p, p, p, i64, i64,
                                       i64, c_int, p, p, p, p]
    lib.sslap_empty.restype = c_int
    lib.sslap_empty.argtypes = [p]
    lib.sslap_smem_optin.restype = c_int
    lib.sslap_smem_optin.argtypes = [c_int]
    lib.sslap_error_string.restype = ctypes.c_char_p
    lib.sslap_error_string.argtypes = [c_int]


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
        nvcc = _nvcc()
        tmp_dir = _BUILD / f"tmp{os.getpid()}"
        tmp_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        objs = [tmp_dir / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen([nvcc, *FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        logs = []
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate(timeout=900)
            logs.append(out)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{out[-4000:]}")
        tmp = tmp_dir / so.name
        out = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({out.returncode}):\n"
                               f"{out.stderr[-4000:]}")
        os.replace(tmp, so)
        shutil.rmtree(tmp_dir, ignore_errors=True)
        build_seconds = time.perf_counter() - t0
        build_log = "".join(logs)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        text = _lib.sslap_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")


def check_smem(nbytes: int, device: torch.device, what: str) -> None:
    """Raise ValueError if a block cannot have ``nbytes`` of dynamic shared
    memory on ``device`` (the opt-in limit; 232,448 bytes on an H100)."""
    limit = load().sslap_smem_optin(device.index or 0)
    if limit < 0:
        check(-limit, what)
    if nbytes > limit:
        raise ValueError(f"{what} needs {nbytes} bytes of shared memory per "
                         f"block; the card allows {limit}")
