"""paddle_tpu_torch.sim — workload traces and the discrete-event fleet
simulator.

Workload traces plus a discrete-event fleet simulator that runs the real
serving host code (Scheduler / BlockManager / Router / HealthConfig /
MigrationPolicy) on a virtual clock, with device steps replaced by
``framework.cost.StepTimeModel`` roofline estimates and generated tokens
by a token oracle:

- clock:      the Clock protocol and the VirtualClock the engines accept
              through ``clock=`` (a verbatim copy of the JAX package's
              ``sim/clock.py``)
- workloads:  named, seeded, replayable traces (a verbatim copy of
              ``paddle_tpu/sim/workloads.py``), all emitting
              ``(arrivals, prompts, new_tokens)`` tuples
- simulator:  SimEngine, run_virtual, simulate, calibrate — many virtual
              replicas on one core, calibrated decision-exactly against
              the real engine's frozen event log
"""

from .clock import SYSTEM_CLOCK, Clock, VirtualClock  # noqa: F401
from .simulator import (  # noqa: F401
    ReplayOracle,
    SimEngine,
    SyntheticOracle,
    calibrate,
    run_virtual,
    sim_engine_factory,
    simulate,
)
from .workloads import (  # noqa: F401
    TRACES,
    agentic_trace,
    build_trace,
    diurnal_trace,
    fleet_trace,
    hot_tenant_trace,
    mixed_trace,
    poisson_trace,
    rag_trace,
    repetitive_trace,
    shared_prefix_trace,
    thousand_tenant_trace,
)

__all__ = [
    "Clock", "VirtualClock", "SYSTEM_CLOCK",
    "SimEngine", "SyntheticOracle", "ReplayOracle",
    "sim_engine_factory", "run_virtual", "simulate", "calibrate",
    "TRACES", "build_trace", "poisson_trace", "shared_prefix_trace",
    "repetitive_trace", "fleet_trace", "mixed_trace", "diurnal_trace",
    "agentic_trace", "thousand_tenant_trace", "rag_trace",
    "hot_tenant_trace",
]
