from repro_torch.obs.drift import PHASES, roofline_drift
from repro_torch.obs.engine import engine_registry, engine_snapshot, snapshot_v2
from repro_torch.obs.metrics import (
    PROMETHEUS_CONTENT_TYPE,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import TRACER, Tracer
