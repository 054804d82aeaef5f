from repro_torch.serving.core import EngineCore, EngineStats, ModelRunner, Request, Scheduler
from repro_torch.serving.outputs import OutputProcessor, RequestOutput
from repro_torch.serving.policy import DrainPolicy, SchedulerView, SwapPolicy, make_policy
from repro_torch.serving.sampling import SamplingParams
