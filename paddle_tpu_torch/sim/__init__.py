"""Workload traces for serving experiments.

``workloads`` is a verbatim copy of ``paddle_tpu/sim/workloads.py``:
named, seeded, replayable request traces (numpy only).  The
discrete-event simulator beside it in the JAX package is not ported.
"""
