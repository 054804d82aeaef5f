"""The port's observability against the JAX package's, on the CPU: the
tracer (ring buffer, drops, exactly-once finish, the Chrome trace's schema
and an engine's lifecycle events), the metrics registry and its Prometheus
text, ``snapshot()`` / ``snapshot_v2()``, the analytic rooflines, the
roofline drift metric, the hardware constants and the arrival traces.

Engines run the tiny config of the JAX package's
``tests/test_async_serving.py`` on the same packed weights (made with numpy
from a seed, carried across by ``interop.params_from_numpy``), beside a live
JAX engine on the same requests.
"""
import omp_passive  # noqa: F401 -- before torch: the OpenMP wait policy
import collections
import dataclasses
import json
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jcfgs
import repro.core.roofline as JR
from repro.common import hardware as JH
from repro.obs import drift as jdrift
from repro.obs.trace import TRACER as JTRACER
from repro.obs.trace import Tracer as JTracer
from repro.serving import EngineCore as JEngineCore
from repro.serving import EngineStats as JEngineStats
from repro.serving import Request as JRequest
from repro.serving import arrivals as jarrivals
from repro.serving.slo import SLOAwareSwapPolicy as JSLOAwareSwapPolicy
from repro.serving.slo import SLOConfig as JSLOConfig

import repro_torch.core.roofline as R
from repro_torch.common import hardware as H
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.models.jax_init import init_like_jax
from repro_torch.obs import (
    PROMETHEUS_CONTENT_TYPE,
    TRACER,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Tracer,
    roofline_drift,
)
from repro_torch.obs import drift
from repro_torch.serving import EngineCore, EngineStats, Request, arrivals
from repro_torch.serving.slo import SLOAwareSwapPolicy, SLOConfig
from test_torch_parity import _numpy_params, _pack_jax, _to_numpy

TINY = dict(num_layers=3, d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2)


@pytest.fixture(scope="module")
def tiny():
    cfg_t = reduced_config("bitnet-730m", **TINY)
    cfg_j = jcfgs.reduced_config("bitnet-730m", use_pallas=True, **TINY)
    params_j = _pack_jax(_numpy_params(cfg_t, seed=0))
    params_t = params_from_numpy(_to_numpy(params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


@pytest.fixture
def tracers():
    """Both packages' process-wide tracers, recording for one test and
    cleared after it."""
    TRACER.enable()
    JTRACER.enable()
    yield TRACER, JTRACER
    for t in (TRACER, JTRACER):
        t.disable()
        t.clear()


def _engines(tiny, **kw):
    cfg_j, params_j, cfg_t, params_t = tiny
    return (EngineCore(cfg_t, params_t, device="cpu", **kw), JEngineCore(cfg_j, params_j, **kw))


# ------------------------------------------------------------------ tracer --


def _script(t, fake_clock):
    """One run of every tracer operation; returns what it raised."""
    raised = []
    t.complete("x", 0.0, 1.0, foo=1)
    t.instant("y")
    t.finish("r", "stop")
    try:
        t.finish("r", "stop")
    except RuntimeError as e:
        raised.append("duplicate" in str(e) and "exactly once" in str(e))
    with t.span("outer", kind="step"):
        with t.span("inner"):
            pass
    t.complete("ship", fake_clock, fake_clock + 1e-3, lane="kv-handoff", bytes=128)
    for i in range(20):
        t.complete("ev", 0.0, 1e-6, i=i)
    return raised


def _shape(events):
    """The events without their times: (kind, name, lane, args)."""
    out = []
    for e in events:
        if e[0] == "X":
            out.append(("X", e[1], e[4] if e[4] != "MainThread" else "main", e[5]))
        else:
            out.append(("i", e[1], e[3] if e[3] != "MainThread" else "main", e[4]))
    return out


@pytest.mark.parametrize("capacity", [None, 8])
def test_tracer_records_drops_and_finishes_as_jax(capacity):
    """The same operations through both tracers: disabled nothing is kept;
    enabled, the same events in the same order, the same ring bound and
    drop count, a second finish of one id raising, and ``enable``/``clear``
    resetting the buffer and the finish set."""
    ours, theirs = Tracer(), JTracer()
    assert _script(ours, 1.0) == _script(theirs, 1.0) == []
    assert ours.events() == theirs.events() == [] and ours.dropped == theirs.dropped == 0
    for t in (ours, theirs):
        t.enable(capacity=capacity)
    assert _script(ours, 1.0) == _script(theirs, 1.0) == [True]
    assert _shape(ours.events()) == _shape(theirs.events())
    assert ours.dropped == theirs.dropped == (0 if capacity is None else 18)
    for t in (ours, theirs):
        t.enable(capacity=16)
        t.finish("r", "stop")  # a fresh finish set
        t.clear()
        t.finish("r", "stop")
    assert _shape(ours.events()) == _shape(theirs.events())
    with pytest.raises(ValueError):
        Tracer(capacity=0)


def _trace_shape(trace):
    meta = [(e["name"], e["ph"], e["pid"], e["tid"], sorted(e["args"]))
            for e in trace["traceEvents"] if e["ph"] == "M"]
    evs = [(e["name"], e["ph"], sorted(e), e.get("args")) for e in trace["traceEvents"]
           if e["ph"] != "M"]
    return sorted(trace), trace["displayTimeUnit"], meta, evs


def test_chrome_trace_schema_is_the_jax_one(tmp_path):
    ours, theirs = Tracer(), JTracer()
    for t in (ours, theirs):
        t.enable()
        _script(t, time.perf_counter())
    got, want = ours.chrome_trace(), theirs.chrome_trace()
    assert _trace_shape(got) == _trace_shape(want)
    lanes = {e["args"]["name"] for e in got["traceEvents"] if e["name"] == "thread_name"}
    assert lanes == {"MainThread", "kv-handoff"}
    spans = {e["name"]: e for e in got["traceEvents"] if e["ph"] == "X"}
    assert 0.0 <= spans["outer"]["ts"] <= spans["inner"]["ts"] and spans["ship"]["ts"] >= 0.0
    path = tmp_path / "trace.json"
    assert json.loads(json.dumps(ours.export_chrome_trace(str(path)))) == json.loads(
        path.read_text())


def _lifecycle(trace):
    """{request id: Counter of its event names} and a Counter of the
    request-free events."""
    per, other = collections.defaultdict(collections.Counter), collections.Counter()
    for e in trace["traceEvents"]:
        if e["ph"] == "M":
            continue
        rid = (e.get("args") or {}).get("request_id")
        (per[rid] if rid else other)[e["name"]] += 1
    return dict(per), other


def _finishes(trace):
    out = {}
    for e in trace["traceEvents"]:
        if e["ph"] == "i" and e["name"] == "req.finish":
            rid = e["args"]["request_id"]
            assert rid not in out, f"a second req.finish for {rid}"
            out[rid] = e["args"]["reason"]
    return out


def _lifecycle_run(eng, request_cls, policy):
    """Preemption and replay on a 7-page pool, then an abort of a queued and
    of a decoding request, then a shed, then a served request."""
    rng = np.random.default_rng(4)
    for i in range(4):
        eng.submit(request_cls(f"p{i}", rng.integers(0, 512, 14).astype(np.int32), max_new=10))
    eng.run()
    assert eng.stats.preemptions > 0 and eng.stats.replayed_tokens > 0
    eng.scheduler.policy = policy
    eng.reset_stats()
    prompt = np.arange(8, dtype=np.int32)
    eng.submit(request_cls("live", prompt.copy(), max_new=12))
    for i in range(4):
        eng.submit(request_cls(f"q{i}", prompt.copy(), max_new=12))
    while "live" not in {r.request_id for r in eng.scheduler.inflight.values()}:
        eng.step()
    assert eng.abort("q3").finish_reason == eng.abort("live").finish_reason == "abort"
    eng.run()
    doomed = request_cls("doomed", prompt.copy(), max_new=2)
    eng.submit(doomed)
    doomed.arrival_time_s -= 1e4
    eng.submit(request_cls("ok", prompt.copy(), max_new=2))
    eng.run()
    assert eng.stats.sheds == 1 and eng.stats.aborts == 2


def test_engine_trace_has_the_jax_engines_events_per_request(tiny, tracers):
    """The same requests through both engines with both tracers on: each
    request has the same events, as many times (preemption, replay, abort,
    shed included), the request-free events (steps, rounds) are counted
    alike, every request finishes exactly once with the JAX engine's reason,
    and the port's spans nest within each lane."""
    ours, theirs = _engines(tiny, n_slots=4, max_len=32, prompt_len=16, cache_layout="paged",
                            block_size=8, num_blocks=7)
    slo = dict(ttft_target_s=100.0, itl_target_s=100.0)
    _lifecycle_run(ours, Request, SLOAwareSwapPolicy(SLOConfig(**slo)))
    _lifecycle_run(theirs, JRequest, JSLOAwareSwapPolicy(JSLOConfig(**slo)))
    got, want = TRACER.chrome_trace(), JTRACER.chrome_trace()
    assert _lifecycle(got) == _lifecycle(want)
    per, other = _lifecycle(got)
    assert {"req.preempt", "replay", "prefill", "swap", "req.admit", "req.submit",
            "req.finish"} <= set(per["p0"]) | set(per["p1"]) | set(per["p2"]) | set(per["p3"])
    assert per["doomed"]["req.shed"] == 1 and per["live"]["req.abort"] == 1
    assert {"engine.step", "decode.round"} <= set(other)
    fins = _finishes(got)
    assert fins == _finishes(want) and fins["doomed"] == "shed" and fins["q3"] == "abort"
    by_lane = collections.defaultdict(list)
    for e in got["traceEvents"]:
        if e["ph"] == "X":
            by_lane[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    for spans in by_lane.values():
        stack = []
        for t0, t1 in sorted(spans):
            while stack and stack[-1] <= t0 + 1e-3:
                stack.pop()
            assert not stack or t1 <= stack[-1] + 1e-3, "spans that do not nest"
            stack.append(t1)


def test_chunked_and_speculative_spans_match_jax(tiny, tracers):
    for kw, reqs in ((dict(prefill_chunk=8, prompt_len=24), [(f"c{i}", n) for i, n in
                                                              enumerate((20, 9, 30))]),
                     (dict(spec_decode=2, prompt_len=16, kv_dtype="int8"), None)):
        ours, theirs = _engines(tiny, n_slots=2, max_len=48, cache_layout="paged", block_size=8,
                                num_blocks=24, **kw)
        for eng, request_cls in ((ours, Request), (theirs, JRequest)):
            if reqs is None:
                base = np.arange(8, dtype=np.int32) % 5 + 3
                for i in range(3):
                    eng.submit(request_cls(f"s{i}", np.tile(base, 2), max_new=10))
            else:
                for rid, n in reqs:
                    eng.submit(request_cls(rid, np.arange(n, dtype=np.int32) % 97, max_new=5))
            eng.run()
    got, want = _lifecycle(TRACER.chrome_trace()), _lifecycle(JTRACER.chrome_trace())
    assert got == want
    assert got[0]["c2"]["prefill.chunk"] == 4 and got[1]["decode.verify"] > 0


def test_tracing_changes_no_token_and_no_counter(tiny):
    """The tracer reads host clocks the engine takes anyway: a run with it
    on gives the tokens and counters of a run with it off."""
    runs = []
    for on in (False, True):
        if on:
            TRACER.enable()
        try:
            eng = _engines(tiny, n_slots=2, max_len=48, cache_layout="paged", block_size=8,
                           num_blocks=24, prefill_chunk=8, prompt_len=24)[0]
            for i, n in enumerate((20, 9, 30)):
                eng.submit(Request(f"c{i}", np.arange(n, dtype=np.int32) % 97, max_new=6))
            eng.run()
        finally:
            TRACER.disable()
            TRACER.clear()
        snap = eng.stats.snapshot()
        runs.append(({k: r.out_tokens for k, r in eng.finished.items()},
                     {k: v for k, v in snap.items() if isinstance(v, int)}))
    assert runs[0] == runs[1]


# ----------------------------------------------------------------- metrics --


def test_metric_primitives_and_prometheus_text():
    c = Counter("c_total")
    c.inc()
    c.inc(2)
    assert c.value == 3.0
    with pytest.raises(ValueError):
        c.inc(-1)
    g = Gauge("g")
    g.set(1.5)
    assert g.value == 1.5
    h = Histogram("h_seconds", window=8)
    for v in range(10):
        h.observe(float(v))
    s = h.summary()
    assert (s["count"], s["sum"], s["mean"]) == (10, 45.0, 4.5)
    assert set(s) == {"count", "sum", "mean", "p50", "p90", "p95", "p99"}
    box = {"v": 1.0}
    view = Counter("v_total", fn=lambda: box["v"])
    box["v"] = 7.0
    assert view.value == 7.0
    for bad in (lambda: view.inc(), lambda: Gauge("g", fn=lambda: 0.0).set(1.0),
                lambda: Histogram("h", source_fn=lambda: None).observe(1.0)):
        with pytest.raises(TypeError):
            bad()
    reg = MetricsRegistry()
    reg.counter("repro_x_total", "a counter").inc(3)
    reg.histogram("repro_lat_seconds", "a histogram").observe(0.5)
    reg.register_collector(lambda: [Counter("repro_lane_total", "per lane", labels={"lane": k},
                                            fn=lambda v=v: v) for k, v in (("a", 1.0), ("b", 2.0))])
    text = reg.prometheus_text()
    assert text.count("# TYPE repro_lane_total counter") == 1
    assert 'repro_lane_total{lane="b"} 2' in text and "# TYPE repro_lat_seconds summary" in text
    assert 'repro_lat_seconds{quantile="0.5"} 0.5' in text and "repro_lat_seconds_count 1" in text
    snap = reg.snapshot()
    assert snap["counters"]["repro_lane_total"] == {"lane=a": 1.0, "lane=b": 2.0}
    assert PROMETHEUS_CONTENT_TYPE == "text/plain; version=0.0.4; charset=utf-8"


def _registry_view(reg):
    """(name, kind, label sets) of every metric, and the counters' values
    (time sums left out)."""
    shape = sorted((m.name, m.kind, tuple(sorted(m.labels or {}))) for m in reg.metrics())
    counters = {}
    for m in reg.metrics():
        if m.kind == "counter" and not m.name.endswith("seconds_total"):
            counters[(m.name, tuple(sorted((m.labels or {}).items())))] = m.value
    return shape, counters


def _workload(eng, request_cls):
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(request_cls(f"m{i}", rng.integers(0, 512, 12).astype(np.int32), max_new=5,
                               tenant=("a", "b", "a")[i]))
    eng.run()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_registry_has_the_jax_metrics_and_counters(tiny, layout):
    """The same metric names, kinds and label sets as the JAX registry over
    the same workload (two tenants), the same counter values; built once,
    live, monotonic, and reset with the stats."""
    kw = dict(n_slots=2, max_len=32, prompt_len=16, cache_layout=layout, block_size=8)
    ours, theirs = _engines(tiny, **kw)
    reg = ours.metrics_registry()
    assert ours.metrics_registry() is reg
    _workload(ours, Request)
    _workload(theirs, JRequest)
    got, want = _registry_view(reg), _registry_view(theirs.metrics_registry())
    assert got == want
    assert got[1][("repro_decode_tokens_total", ())] == ours.stats.decode_tokens > 0
    text = reg.prometheus_text()
    assert 'repro_tenant_queued{tenant="a"} 0' in text
    assert 'repro_roofline_residency_ratio{phase="prefill"}' in text
    ours.reset_stats()
    assert reg.snapshot()["counters"]["repro_decode_tokens_total"] == 0.0


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_snapshots_have_the_jax_keys_and_counters(tiny):
    ours, theirs = _engines(tiny, n_slots=2, max_len=32, prompt_len=16, cache_layout="paged",
                            block_size=8)
    _workload(ours, Request)
    _workload(theirs, JRequest)
    for mine, jax_one in ((ours.snapshot(), theirs.snapshot()),
                          (ours.snapshot_v2(), theirs.snapshot_v2())):
        assert _keys(mine) == _keys(jax_one)
    snap, jsnap = ours.snapshot(), theirs.snapshot()
    for k, v in snap.items():
        if isinstance(v, int) and not isinstance(v, bool):
            assert v == jsnap[k], k
    assert snap["kv_bytes"] == jsnap["kv_bytes"]
    assert {t: v["queued"] for t, v in snap["tenants"].items()} == {"a": 0, "b": 0}
    assert snap["tenants"]["a"]["queue_wait_s"]["count"] == 2
    v2 = ours.snapshot_v2()
    assert v2["schema"] == "v2" and v2["counters"]["repro_swaps_total"] == float(snap["swaps"])
    assert v2["gauges"]["repro_kv_cache_bytes"]["kind=allocated"] == float(
        snap["kv_bytes"]["allocated"])


def test_registry_holds_no_reference_cycle_to_its_engine(tiny):
    """A registry cached on its engine reaches it through weak proxies: the
    engine is freed by reference counting alone, never by the collector."""
    import gc
    import weakref

    eng = _engines(tiny, n_slots=1, max_len=32, prompt_len=16)[0]
    eng.metrics_registry().prometheus_text()
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------- rooflines --


def _close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
def test_roofline_functions_equal_jax_on_tpu_v5e(kv_dtype):
    """Every analytic function with ``TPU_V5E`` passed to both packages, at
    the full bitnet-730m config and the tiny one, within 1e-12 relative."""
    for cfg_t, cfg_j in ((reduced_config("bitnet-730m", **TINY),
                          jcfgs.reduced_config("bitnet-730m", **TINY)),
                         (reduced_config("bitnet-730m", num_layers=24, d_model=1536,
                                         num_heads=24, num_kv_heads=24, head_dim=64),
                          jcfgs.get_config("bitnet-730m"))):
        chip, jchip = H.TPU_V5E, JH.TPU_V5E
        for inc in (True, False):
            assert _close(R.kv_bytes_per_ctx_token(cfg_t, kv_dtype, include_scales=inc),
                          JR.kv_bytes_per_ctx_token(cfg_j, kv_dtype, include_scales=inc))
        assert _close(R.decode_arithmetic_intensity(cfg_t, kv_dtype),
                      JR.decode_arithmetic_intensity(cfg_j, kv_dtype))
        for ctx in (0, 1, 517, 2048):
            assert _close(R.decode_kv_stream_time(cfg_t, ctx, kv_dtype, chip),
                          JR.decode_kv_stream_time(cfg_j, ctx, kv_dtype, jchip))
            for k, p in ((0, 0.5), (4, 0.0), (4, 0.56), (3, 1.0), (2, 1.7)):
                assert _close(R.expected_accept_length(k, p), JR.expected_accept_length(k, p))
                assert _close(R.decode_kv_stream_time_speculative(cfg_t, ctx, k, p, kv_dtype, chip),
                              JR.decode_kv_stream_time_speculative(cfg_j, ctx, k, p, kv_dtype,
                                                                   jchip))
            for phase in ("prefill", "decode", "spec_verify"):
                kw = dict(n_params=7.3e8, context=ctx, kv_dtype=kv_dtype, batch=4, k=4,
                          accept_rate=0.56)
                a = R.predict_phase(phase, cfg_t, chip=chip, **kw)
                b = JR.predict_phase(phase, cfg_j, chip=jchip, **kw)
                assert (a.phase, a.kv_dtype) == (b.phase, b.kv_dtype)
                for f in ("flops", "hbm_bytes", "t_per_token"):
                    assert _close(getattr(a, f), getattr(b, f)), (phase, f)
        assert _close(R.prefill_compute_time(7.3e8, chip), JR.prefill_compute_time(7.3e8, jchip))
        assert R.roofline_residency(1.0, 0.0) == JR.roofline_residency(1.0, 0.0) == 0.0
        assert _close(R.roofline_residency(2e-6, 3e-3), JR.roofline_residency(2e-6, 3e-3))
    with pytest.raises(ValueError):
        R.kv_bytes_per_ctx_token(cfg_t, "fp8")
    with pytest.raises(ValueError):
        R.predict_phase("train", cfg_t)


def test_hardware_constants():
    assert dataclasses.asdict(H.TPU_V5E) == dataclasses.asdict(JH.TPU_V5E)
    h = H.H100_SXM
    assert H.DEFAULT_CHIP is h and JH.DEFAULT_CHIP.name == "tpu-v5e"
    assert (h.peak_flops_bf16, h.peak_flops_int8, h.hbm_bw) == (989e12, 1979e12, 3.35e12)
    assert h.hbm_bytes == 80 * 1024**3 and h.vmem_bytes == 50 * 1024**2
    assert h.ici_bw_per_link * h.ici_links * 2 == 900e9 and h.dcn_bw * 2 == 128e9


def _stats_pair(spec):
    """The same counters in both packages' EngineStats."""
    vals = dict(prefill_tokens=1200, t_prefill=0.37, decode_tokens=640, t_decode=2.9,
                decode_rounds=180, slot_rounds=560, decode_ctx_tokens=560 * 700)
    if spec:
        vals.update(verify_rounds=120, draft_tokens=900, accepted_tokens=505)
    return EngineStats(**vals), JEngineStats(**vals)


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("spec", [None, 4])
def test_roofline_drift_equals_jax_for_the_same_stats_and_chip(tiny, kv_dtype, spec):
    """``roofline_drift(core, TPU_V5E)`` of the port equals the JAX one on
    the same stats, config and latent weights (the JAX parameter count),
    every number within 1e-12 relative."""
    cfg_j, _, cfg_t, _ = tiny
    tree = _numpy_params(cfg_t, seed=1)
    st, jst = _stats_pair(spec)
    runner = SimpleNamespace(cfg=cfg_t, kv_dtype=kv_dtype, spec_decode=spec,
                             params=params_from_numpy(tree, dataclasses.replace(
                                 cfg_t, quant=dataclasses.replace(cfg_t.quant, mode="none")),
                                 device="cpu"))
    jrunner = SimpleNamespace(cfg=cfg_j, kv_dtype=kv_dtype, spec_decode=spec,
                              params=jax.tree.map(jnp.asarray, tree))
    got = roofline_drift(SimpleNamespace(stats=st, runner=runner), H.TPU_V5E)
    want = jdrift.roofline_drift(SimpleNamespace(stats=jst, runner=jrunner))
    assert set(got) == set(want) == ({"prefill", "decode", "spec_verify"} if spec
                                     else {"prefill", "decode"})
    for phase in got:
        assert set(got[phase]) == set(want[phase])
        for k, v in got[phase].items():
            assert v == want[phase][k] if isinstance(v, str) else _close(v, want[phase][k]), (
                phase, k)
    empty = SimpleNamespace(stats=EngineStats(), runner=runner)
    assert roofline_drift(empty) == {}


def test_parameter_count_latent_and_packed(tiny):
    """Latent weights: the JAX count (the sum of the leaves' sizes).  Packed
    ternary weights: the port counts K x N a linear, the model's
    parameters, where the JAX sum of ``.size`` counts the (K/4, N) packed
    words and the scalar beta of each layer (ROADMAP C)."""
    cfg_j, params_j, cfg_t, params_t = tiny
    cfg_full = reduced_config("bitnet-730m", **TINY)
    latent = init_like_jax(cfg_full, 0, "cpu")
    jlatent = jax.tree.map(jnp.asarray, {"emb": latent["emb"].numpy(),
                                         "layers": jax.tree.map(lambda t: t.numpy(),
                                                                latent["layers"]),
                                         "ln_f": {"scale": latent["ln_f"]["scale"].numpy()}})
    n_latent = drift._n_params(SimpleNamespace(params=latent))
    assert n_latent == jdrift._n_params(SimpleNamespace(params=jlatent))
    packed = drift._n_params(SimpleNamespace(params=params_t))
    jpacked = jdrift._n_params(SimpleNamespace(params=params_j))
    L, d, f = cfg_t.num_layers, cfg_t.d_model, cfg_t.d_ff
    hq, hkv = cfg_t.num_heads * cfg_t.head_dim, cfg_t.num_kv_heads * cfg_t.head_dim
    kn = L * (d * hq + 2 * d * hkv + hq * d + 3 * d * f)
    rest = cfg_t.padded_vocab() * d + 2 * L * d + d  # embedding and norms
    assert packed == kn + rest == n_latent
    assert jpacked == kn // 4 + 7 * L + rest


# ----------------------------------------------------------------- arrivals --


def test_arrival_traces_equal_jax():
    for seed in (0, 3):
        a = arrivals.poisson_times(7.5, 50, np.random.default_rng(seed))
        b = jarrivals.poisson_times(7.5, 50, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
        a = arrivals.bursty_times(2.0, 9.0, 1.5, 60, np.random.default_rng(seed))
        b = jarrivals.bursty_times(2.0, 9.0, 1.5, 60, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
        for kw in (dict(), dict(kind="bursty", rate=3.0, period_s=0.5, prompt_lens=(4, 40),
                                tenants=(("a", 1.0, 3.0), ("b", 3.0, 1.0)))):
            got = arrivals.make_trace(40, seed=seed, **kw)
            want = jarrivals.make_trace(40, seed=seed, **kw)
            assert [dataclasses.astuple(x) for x in got] == [dataclasses.astuple(x) for x in want]
    for bad in (lambda: arrivals.poisson_times(0.0, 3, np.random.default_rng(0)),
                lambda: arrivals.make_trace(3, kind="storm"),
                lambda: arrivals.make_trace(3, prompt_lens=(5, 2))):
        with pytest.raises(ValueError):
            bad()
