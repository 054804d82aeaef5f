from repro_torch.serving.arrivals import Arrival, bursty_times, make_trace, poisson_times
from repro_torch.serving.async_engine import AdmissionRejected, AsyncEngine, RequestStream
from repro_torch.serving.core import EngineCore, EngineStats, ModelRunner, Request, Scheduler
from repro_torch.serving.disagg import DisaggEngine, DisaggRunner, KVHandoffChannel, PrefillPool
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.fair_queue import WeightedFairQueue
from repro_torch.serving.outputs import OutputProcessor, RequestOutput
from repro_torch.serving.paging import BlockPool, PagedKVCache, PoolExhausted
from repro_torch.serving.policy import (
    POLICIES,
    DrainPolicy,
    SchedulerView,
    SwapCostAwarePolicy,
    SwapPolicy,
    make_policy,
)
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.slo import LatencyStat, SLOAwareSwapPolicy, SLOConfig
