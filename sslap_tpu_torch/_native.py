"""The shared C++ host runtime, reached without importing the JAX package.

``sslap_tpu/__init__.py`` imports jax (through its ``api`` module), and the
GPU deployment has no jax.  ``sslap_tpu/native/build.py`` itself imports
only ctypes, numpy and the standard library, so it is loaded here by file
path: the port gets the one C++ source (``sslap_native.cpp``, compiled
with g++ into ``sslap_tpu/native/_build/``) and its ctypes wrappers, with
no copy.  ``sslap_tpu/gs_host.py`` (pure numpy) is loaded the same way as
the no-toolchain fallback of the Gauss-Seidel engine.

Every wrapper is None when the native library could not be built; callers
fall back to numpy, as the JAX package's callers do.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

_REF = Path(__file__).resolve().parent.parent / "sslap_tpu"


def _load_by_path(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_build = _load_by_path("_sslap_tpu_torch_native_build",
                       _REF / "native" / "build.py")
gs_host = _load_by_path("_sslap_tpu_torch_gs_host", _REF / "gs_host.py")

_lib = _build.load_native()


def native_available() -> bool:
    return _lib is not None


if _lib is not None:
    auction_gs = _build.auction_gs
    auction_gs_fr = _build.auction_gs_fr
    build_ell_native = _build.build_ell_native
    ell_to_csr_native = _build.ell_to_csr_native
    fr_tighten_native = _build.fr_tighten_native
    hopcroft_karp_native = _build.hopcroft_karp_native
    hopcroft_karp_native_i32 = _build.hopcroft_karp_native_i32
    hopcroft_karp_warm_native = _build.hopcroft_karp_warm_native
    unassign_violators_native = _build.unassign_violators_native
else:  # no toolchain: callers use the numpy paths
    auction_gs = None
    auction_gs_fr = None
    build_ell_native = None
    ell_to_csr_native = None
    fr_tighten_native = None
    hopcroft_karp_native = None
    hopcroft_karp_native_i32 = None
    hopcroft_karp_warm_native = None
    unassign_violators_native = None
