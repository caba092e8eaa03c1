from .cache import PrefixCache, SlotArena, SlotExhausted, StackedSlotArenas
from .engine import (ContinuousBatchingEngine, EngineOptions,
                     FinishedRequest, GenerationResult, PathServingEngine)
from .fleet import ServingFleet
from .scheduler import (PRIO_HIGH, PRIO_PREEMPTIBLE, PRIO_STANDARD, Request,
                        RequestState, Scheduler, SchedulerStats,
                        poisson_trace, prefix_hash_router)

__all__ = ["ContinuousBatchingEngine", "EngineOptions", "FinishedRequest",
           "GenerationResult", "PRIO_HIGH", "PRIO_PREEMPTIBLE",
           "PRIO_STANDARD", "PathServingEngine", "PrefixCache", "Request",
           "RequestState", "Scheduler", "SchedulerStats", "ServingFleet",
           "SlotArena", "SlotExhausted", "StackedSlotArenas", "poisson_trace",
           "prefix_hash_router"]
