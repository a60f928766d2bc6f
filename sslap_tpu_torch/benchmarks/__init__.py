"""Workload harnesses of the port, run as modules: ``python -m
sslap_tpu_torch.benchmarks.tracking`` (the tracking workload, counterpart
of ``benchmarks/tracking.py``)."""
