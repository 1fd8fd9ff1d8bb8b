"""repro_torch.core — the paper's contribution: node-to-PU scheduling for
hybrid in-memory-computing inference engines, plus the IMCE simulator.

The port's copy of ``repro.core``: the same module paths, names, structure
and float arithmetic, in plain stdlib Python (no tensors, no device), so
that every assignment and ``SimResult`` equals the reference's field for
field.  The simulator keeps the reference's optional ``numpy`` import: its
scalar fallback is bit-equal.  The elastic tier (``elastic``), the
serving control plane (``serving``) and the LM pipeline-stage partitioner
(``pipeline_partition``) are copies too: their events, audits and stage
boundaries equal the reference's.
"""

from .cost import (
    CostModel,
    HardwareProfile,
    IMCE_DEFAULT,
    IMCE_FAST_LINK,
    PUSpec,
    make_pus,
)
from .graph import (FREE_KINDS, IMC_KINDS, Graph, GraphError,
                    MultiTenantGraph, Node, OpKind, PUType, default_pu_type)
from .metrics import NormalizedPoint, normalize, utilization_table
from .schedulers import (
    Assignment,
    ScheduleError,
    Scheduler,
    available,
    get_scheduler,
    schedule_replicated,
)
from .simcontext import TIME_SCALE, SimContext
from .simulator import (
    IMCESimulator,
    MultiTenantSimulator,
    SimResult,
    TenantMetrics,
)


def make_simulator(graph, cost_model=None, engine: str = "exact",
                   max_in_flight: int = 0):
    """Simulator factory over the three engines.

    ``engine`` is ``"exact"`` (compiled loop, bit-identical to the
    historical simulator), ``"periodic"`` (quantized time grid +
    steady-state early exit; the benchmark default) or ``"reference"``
    (the frozen pre-compilation loop kept for equivalence testing and
    honest speedup measurement).  Returns the multi-tenant front-end
    automatically for :class:`MultiTenantGraph` inputs.
    """
    multi = isinstance(graph, MultiTenantGraph)
    if engine == "reference":
        from ._sim_reference import (ReferenceMultiTenantSimulator,
                                     ReferenceSimulator)
        cls = ReferenceMultiTenantSimulator if multi else ReferenceSimulator
        return cls(graph, cost_model, max_in_flight)
    cls = MultiTenantSimulator if multi else IMCESimulator
    return cls(graph, cost_model, max_in_flight, mode=engine)


# imported after make_simulator exists: serving builds on the factory
from .serving import (  # noqa: E402  (deliberate late import)
    SLO,
    Decision,
    ServingControlPlane,
    SLOReport,
    TraceEvent,
    aggregate_goodput,
    dump_trace,
    load_trace,
)

__all__ = [
    "CostModel",
    "HardwareProfile",
    "IMCE_DEFAULT",
    "IMCE_FAST_LINK",
    "PUSpec",
    "make_pus",
    "FREE_KINDS",
    "IMC_KINDS",
    "Graph",
    "GraphError",
    "MultiTenantGraph",
    "Node",
    "OpKind",
    "PUType",
    "default_pu_type",
    "NormalizedPoint",
    "normalize",
    "utilization_table",
    "Assignment",
    "ScheduleError",
    "Scheduler",
    "available",
    "get_scheduler",
    "schedule_replicated",
    "IMCESimulator",
    "MultiTenantSimulator",
    "SimResult",
    "TenantMetrics",
    "SimContext",
    "TIME_SCALE",
    "make_simulator",
    "SLO",
    "Decision",
    "ServingControlPlane",
    "SLOReport",
    "TraceEvent",
    "aggregate_goodput",
    "dump_trace",
    "load_trace",
]
