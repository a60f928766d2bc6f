"""The port's C++ host runtime (``native/``) and its numpy fallback
(``gs_host.py``).

Both are the port's own copies of ``sslap_tpu/native/`` and
``sslap_tpu/gs_host.py``: the GPU deployment has no jax, and the port
imports nothing of the JAX package.  The library is compiled with g++
into ``sslap_tpu_torch/_build/native/`` at first import.

Every wrapper is None when the native library could not be built; callers
fall back to numpy, as the JAX package's callers do.
"""

from __future__ import annotations

from sslap_tpu_torch import gs_host  # noqa: F401  (the numpy fallback)
from sslap_tpu_torch.native import build as _build

_lib = _build.load_native()


def native_available() -> bool:
    return _lib is not None


if _lib is not None:
    auction_gs = _build.auction_gs
    auction_gs_fr = _build.auction_gs_fr
    build_ell_native = _build.build_ell_native
    csr_to_csc_native = _build.csr_to_csc_native
    ell_to_csr_native = _build.ell_to_csr_native
    fr_tighten_native = _build.fr_tighten_native
    hopcroft_karp_native = _build.hopcroft_karp_native
    hopcroft_karp_native_i32 = _build.hopcroft_karp_native_i32
    hopcroft_karp_warm_native = _build.hopcroft_karp_warm_native
    max_matching_size_native_i32 = _build.max_matching_size_native_i32
    unassign_violators_native = _build.unassign_violators_native
else:  # no toolchain: callers use the numpy paths
    auction_gs = None
    auction_gs_fr = None
    build_ell_native = None
    csr_to_csc_native = None
    ell_to_csr_native = None
    fr_tighten_native = None
    hopcroft_karp_native = None
    hopcroft_karp_native_i32 = None
    hopcroft_karp_warm_native = None
    max_matching_size_native_i32 = None
    unassign_violators_native = None
