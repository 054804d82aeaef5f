"""Engine-facing observability: one snapshot builder and one metrics
registry over ``EngineCore`` and ``AsyncEngine``.

The port of the JAX package's ``repro.obs.engine``.

* ``engine_snapshot(core)`` builds the stats block every surface reports
  (``EngineStats.snapshot()``, KV accounting, the tenants' lanes, roofline
  drift), with the sections ``core.snapshot_sections()`` adds and the
  front end's admission counters as ``extra``;
* ``engine_registry(core, frontend=None)`` builds a ``MetricsRegistry`` of
  callback views over the live engine: every ``EngineStats`` counter, the
  ``LatencyStat`` windows as quantile summaries, KV accounting, the tenants'
  lanes and the front end's admissions (collectors), the tracer, and the
  per-phase ``repro_roofline_residency_ratio`` gauges.  The views read
  ``core.stats`` at collect time, so ``reset_stats()`` is seen;
* ``snapshot_v2(core)`` is the registry's structured export, the numbers
  ``GET /metrics`` serves as Prometheus text.

Everything here reads host state and tensor shapes, never the device, so
the event loop can scrape while the engine's thread runs a step.  The views
hold the engine and the front end through weak proxies: a registry cached
on its engine makes no reference cycle back to it (a graph freed by the
cycle collector while another is captured would end that capture).
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Optional

from repro_torch.obs.drift import PHASES, roofline_drift
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import TRACER

# (EngineStats attribute, metric name, help): the registry's counters over
# the stats block; times are monotonic sums, hence counters
_STAT_COUNTERS = (
    ("prefill_tokens", "repro_prefill_tokens_total",
     "Prompt tokens prefilled (offered load; restarts excluded)"),
    ("decode_tokens", "repro_decode_tokens_total", "Tokens produced by decode/verify rounds"),
    ("decode_rounds", "repro_decode_rounds_total", "Decode quanta executed"),
    ("swaps", "repro_swaps_total", "Logical prefill->decode swaps (one per request)"),
    ("prefill_bursts", "repro_prefill_bursts_total", "Prefill phases entered (fabric flips)"),
    ("prefill_chunks", "repro_prefill_chunks_total", "Chunked-prefill quanta executed"),
    ("prefix_hits", "repro_prefix_hits_total", "Prompt pages served from the prefix cache"),
    ("prefix_misses", "repro_prefix_misses_total", "Full prompt pages written"),
    ("prefix_hit_tokens", "repro_prefix_hit_tokens_total", "Tokens covered by prefix-cache hits"),
    ("preemptions", "repro_preemptions_total", "Requests evicted under pool pressure"),
    ("admission_blocks", "repro_admission_blocks_total", "Admissions deferred on pool pressure"),
    ("replayed_tokens", "repro_replayed_tokens_total",
     "Recompute overhead tokens from preemption restarts"),
    ("draft_tokens", "repro_spec_draft_tokens_total", "Draft tokens proposed to verify"),
    ("accepted_tokens", "repro_spec_accepted_tokens_total",
     "Draft tokens the verify pass confirmed"),
    ("verify_rounds", "repro_spec_verify_rounds_total",
     "Decode rounds run through the verify program"),
    ("slot_rounds", "repro_slot_rounds_total", "Sum over decode rounds of active slots"),
    ("aborts", "repro_aborts_total", "Requests cancelled mid-flight or queued"),
    ("sheds", "repro_sheds_total", "Queue heads dropped by SLO admission control"),
    ("decode_ctx_tokens", "repro_decode_ctx_tokens_total",
     "Context tokens streamed per decode pass, summed over slot-rounds"),
    ("t_prefill", "repro_prefill_seconds_total", "Wall time in prefill compute"),
    ("t_decode", "repro_decode_seconds_total", "Wall time in decode/verify rounds"),
    ("t_replay", "repro_replay_seconds_total", "Wall time replaying preemption restarts"),
)

_LATENCY_HISTOGRAMS = (
    ("queue_wait", "repro_queue_wait_seconds", "Arrival to first successful admission"),
    ("ttft", "repro_ttft_seconds", "Arrival to first emitted token"),
    ("itl", "repro_itl_seconds", "Gap between consecutive streamed deltas"),
)


def engine_snapshot(core, extra: Optional[Dict[str, Any]] = None) -> dict:
    """The stats block every surface reports: ``EngineStats.snapshot()``,
    KV accounting, the tenants' fair-queue lanes and queue waits, roofline
    drift, ``core.snapshot_sections()`` and the front end's ``extra``."""
    from repro_torch.serving.slo import LatencyStat

    snap = core.stats.snapshot()
    snap["kv_bytes"] = core.kv_bytes()
    depths = core.scheduler.queue.lane_depths()
    waits = core.stats.tenant_queue_wait
    snap["tenants"] = {
        t: {"queued": depths.get(t, 0),
            "queue_wait_s": waits[t].snapshot() if t in waits else LatencyStat().snapshot()}
        for t in sorted(set(depths) | set(waits))
    }
    snap["roofline_drift"] = roofline_drift(core)
    sections = getattr(core, "snapshot_sections", None)
    if sections is not None:
        snap.update(sections())
    if extra:
        snap.update(extra)
    return snap


def engine_registry(core, frontend=None) -> MetricsRegistry:
    """The typed registry over one engine (and its async front end).  Every
    metric is a callback view: built once, it serves every scrape."""
    core = weakref.proxy(core)
    reg = MetricsRegistry()
    for attr, name, help_ in _STAT_COUNTERS:
        reg.counter(name, help_, fn=lambda a=attr: float(getattr(core.stats, a)))

    reg.gauge("repro_decode_tput_tokens_per_s", "Decode throughput (decode_tokens / t_decode)",
              fn=lambda: core.stats.decode_tput())
    reg.gauge("repro_decode_round_cost_seconds", "Mean wall time of one decode round",
              fn=lambda: core.stats.decode_round_cost())
    reg.gauge("repro_spec_acceptance_rate", "Fraction of proposed draft tokens accepted",
              fn=lambda: core.stats.acceptance_rate())
    reg.gauge("repro_spec_tokens_per_round", "Mean tokens emitted per slot per decode round",
              fn=lambda: core.stats.tokens_per_round())
    reg.gauge("repro_swap_exposed_cost_seconds", "Mean decode-visible swap latency",
              fn=lambda: core.stats.swap_agg.mean_cost)
    reg.gauge("repro_swap_hidden_fraction",
              "Mean fraction of swap latency hidden under the prefill tail",
              fn=lambda: core.stats.swap_agg.mean_hidden_fraction)
    for kind in ("allocated", "peak_in_use", "payload"):
        reg.gauge("repro_kv_cache_bytes", "KV cache memory accounting", labels={"kind": kind},
                  fn=lambda k=kind: float(core.kv_bytes()[k]))
    reg.gauge("repro_queue_depth", "Requests in the scheduler wait queue",
              fn=lambda: float(len(core.scheduler.queue)))
    reg.gauge("repro_active_slots", "Slots currently decoding",
              fn=lambda: float(len(core.scheduler.inflight)))
    reg.gauge("repro_prefilling_slots", "Slots mid-(chunked-)prefill",
              fn=lambda: float(len(core._prefilling)))

    for attr, name, help_ in _LATENCY_HISTOGRAMS:
        reg.histogram(name, help_, source_fn=lambda a=attr: getattr(core.stats, a))

    for phase in PHASES:
        reg.gauge(
            "repro_roofline_residency_ratio",
            "Analytic roofline bound / measured seconds-per-token, per phase "
            "(1.0 = running at the bound; falling = efficiency drift)",
            labels={"phase": phase},
            fn=lambda p=phase: float(
                roofline_drift(core).get(p, {}).get("residency_ratio", 0.0)))

    def tenant_metrics():
        depths = core.scheduler.queue.lane_depths()
        waits = core.stats.tenant_queue_wait
        out = []
        for t in sorted(set(depths) | set(waits)):
            out.append(Gauge("repro_tenant_queued", "Queued requests per tenant lane",
                             labels={"tenant": t}, fn=lambda d=depths.get(t, 0): float(d)))
            if t in waits:
                out.append(Histogram("repro_tenant_queue_wait_seconds", "Per-tenant queue wait",
                                     labels={"tenant": t}, source_fn=lambda w=waits[t]: w))
        return out

    reg.register_collector(tenant_metrics)

    reg.gauge("repro_trace_enabled", "1 when the tracer is recording",
              fn=lambda: float(TRACER.enabled))
    reg.gauge("repro_trace_buffered_events", "Events in the trace ring buffer",
              fn=lambda: float(len(TRACER.events())))
    reg.counter("repro_trace_dropped_events_total", "Events evicted by the trace ring bound",
                fn=lambda: float(TRACER.dropped))

    if frontend is not None:
        frontend = weakref.proxy(frontend)
        reg.counter("repro_frontend_accepted_total", "Requests admitted by the async front-end",
                    fn=lambda: float(frontend.accepted))
        reg.counter("repro_frontend_rejected_total",
                    "Submissions refused (backpressure or invalid)",
                    fn=lambda: float(frontend.rejected))
        reg.gauge("repro_frontend_pending", "Accepted requests not yet drained into the core",
                  fn=lambda: float(len(frontend._pending)))
        reg.gauge("repro_frontend_open_streams", "Live client output streams",
                  fn=lambda: float(len(frontend._streams)))
        reg.gauge("repro_frontend_max_queue", "Backpressure bound",
                  fn=lambda: float(frontend.max_queue))

        def reject_metrics():
            return [Counter("repro_frontend_reject_reasons_total",
                            "Rejections by machine-readable reason", labels={"reason": r},
                            fn=lambda n=n: float(n))
                    for r, n in sorted(frontend.reject_reasons.items())]

        reg.register_collector(reject_metrics)
    return reg


def snapshot_v2(core, registry: Optional[MetricsRegistry] = None, frontend=None) -> dict:
    """The registry's structured export: ``{"schema": "v2", "counters",
    "gauges", "histograms"}``."""
    reg = registry if registry is not None else engine_registry(core, frontend=frontend)
    out = reg.snapshot()
    out["schema"] = "v2"
    return out
