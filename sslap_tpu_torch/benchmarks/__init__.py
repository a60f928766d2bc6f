"""Workload harnesses of the port, run as modules: ``python -m
sslap_tpu_torch.benchmarks.tracking`` (the tracking workload, counterpart
of ``benchmarks/tracking.py``) and ``python -m
sslap_tpu_torch.benchmarks.fuzz`` (the differential fuzz against scipy
and, on the card, against the CPU; counterpart of ``benchmarks/fuzz.py``)."""
