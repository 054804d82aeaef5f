from repro_torch.serving.core import EngineCore, EngineStats, ModelRunner, Request, Scheduler
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.outputs import OutputProcessor, RequestOutput
from repro_torch.serving.policy import (
    POLICIES,
    DrainPolicy,
    SchedulerView,
    SwapCostAwarePolicy,
    SwapPolicy,
    make_policy,
)
from repro_torch.serving.sampling import SamplingParams
