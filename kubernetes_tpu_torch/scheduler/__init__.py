"""The CPU oracle: NodeInfo, predicates, priorities, GenericScheduler."""

from .generic_scheduler import FitError, GenericScheduler, ScheduleResult
from .nodeinfo import NodeInfo
from .predicates import DEFAULT_PREDICATES, PredicateContext
from .priorities import PriorityContext, default_priorities
