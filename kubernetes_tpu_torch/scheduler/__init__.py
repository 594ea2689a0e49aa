"""The scheduler: the CPU oracle (NodeInfo, predicates, priorities,
GenericScheduler), the scheduler cache and queue, and ``Scheduler`` with
its batch seam onto ``ops.backend.BatchBackend``."""

from .generic_scheduler import FitError, GenericScheduler, ScheduleResult
from .nodeinfo import NodeInfo, SchedulerCache
from .predicates import (
    DEFAULT_PREDICATES,
    PredicateContext,
    PredicateMetadata,
    compute_metadata,
    pod_fits_on_node,
)
from .priorities import (
    BalancedResourceAllocation,
    EqualPriority,
    ImageLocalityPriority,
    InterPodAffinityPriority,
    LeastRequestedPriority,
    MostRequestedPriority,
    NodeAffinityPriority,
    NodePreferAvoidPodsPriority,
    PriorityContext,
    SelectorSpreadPriority,
    TaintTolerationPriority,
    cluster_autoscaler_priorities,
    default_priorities,
)
from .queue import PodBackoff, SchedulingQueue
from .scheduler import Scheduler
from .units import (
    CPU_MILLI,
    GPU_COUNT,
    MAX_PRIORITY,
    MEM_MIB,
    NUM_RESOURCES,
    STORAGE_MIB,
    ResourceVec,
    pod_nonzero_request_vec,
    pod_request_vec,
)
