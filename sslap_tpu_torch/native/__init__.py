"""The port's native (C++) host runtime: ``sslap_native.cpp`` and its
ctypes loader ``build.py``, copies of ``sslap_tpu/native/``.  Reached
through ``sslap_tpu_torch._native``, which falls back to numpy when the
library cannot be built."""
