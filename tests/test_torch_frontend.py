"""The port's front end against the JAX package's, on the CPU: the weighted
fair queue, the latency windows, the SLO-aware policy with its shedding and
chunk widening, ``AsyncEngine`` (streams, tenants, rejections, aborts), the
HTTP/SSE server with its graceful drain, and the serving CLI.

Every engine runs the tiny config of the JAX package's
``tests/test_async_serving.py`` on the same packed weights (made with numpy
from a seed, packed by the JAX package and carried across by
``interop.params_from_numpy``), and is held against a live run of the JAX
package, token for token.
"""
import asyncio
import contextlib
import copy
import functools
import io
import json
import socket
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.launch.serve as jserve
from repro.serving import AdmissionRejected as JAdmissionRejected
from repro.serving import AsyncEngine as JAsyncEngine
from repro.serving import EngineCore as JEngineCore
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import SchedulerView as JSchedulerView
from repro.serving.fair_queue import WeightedFairQueue as JWeightedFairQueue
from repro.serving.slo import LatencyStat as JLatencyStat
from repro.serving.slo import SLOAwareSwapPolicy as JSLOAwareSwapPolicy
from repro.serving.slo import SLOConfig as JSLOConfig
from repro.serving.slo import request_latency as j_request_latency

from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.obs.metrics import PROMETHEUS_CONTENT_TYPE
from repro_torch.obs.trace import TRACER
from repro_torch.serving import (
    AdmissionRejected,
    AsyncEngine,
    EngineCore,
    LatencyStat,
    Request,
    SamplingParams,
    SchedulerView,
    SLOAwareSwapPolicy,
    SLOConfig,
    WeightedFairQueue,
    make_policy,
)
from repro_torch.serving.slo import request_latency
from test_torch_parity import _numpy_params, _pack_jax, _to_numpy

TINY = dict(num_layers=3, d_model=128, vocab_size=512, num_heads=4, num_kv_heads=2)


@pytest.fixture(scope="module")
def tiny():
    cfg_t = reduced_config("bitnet-730m", **TINY)
    cfg_j = jcfgs.reduced_config("bitnet-730m", use_pallas=True, **TINY)
    params_j = _pack_jax(_numpy_params(cfg_t, seed=0))
    params_t = params_from_numpy(_to_numpy(params_j), cfg_t, device="cpu")
    return cfg_j, params_j, cfg_t, params_t


def _engines(tiny, **kw):
    """A port engine (on the CPU) and a JAX engine of the same config."""
    cfg_j, params_j, cfg_t, params_t = tiny
    return (EngineCore(cfg_t, params_t, device="cpu", **kw),
            JEngineCore(cfg_j, params_j, **kw))


def _requests(n=3, lo=5, hi=12, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(0, 512, int(rng.integers(lo, hi + 1))).astype(np.int32),
             max_new) for i in range(n)]


def _sync_tokens(eng, reqs, request_cls):
    for rid, prompt, max_new in reqs:
        eng.submit(request_cls(rid, prompt.copy(), max_new=max_new))
    eng.run()
    return {rid: list(eng.finished[rid].out_tokens) for rid, _, _ in reqs}


def _async_tokens(core, async_cls, reqs, *, max_queue=32, tenants=None):
    async def go():
        toks = {}
        async with async_cls(core, max_queue=max_queue) as eng:
            streams = {}
            for i, (rid, prompt, max_new) in enumerate(reqs):
                kw = {}
                if tenants:
                    kw["tenant"], kw["weight"] = tenants[i % len(tenants)]
                streams[rid] = await eng.submit(prompt.copy(), request_id=rid, max_new=max_new,
                                                **kw)
            for rid, stream in streams.items():
                got = []
                async for out in stream:
                    got.extend(out.new_token_ids)
                    if out.finished:
                        assert out.finish_reason in ("stop", "length")
                toks[rid] = got
        return toks

    return asyncio.run(go())


# ------------------------------------------------------ weighted fair queue --


class _Req:
    def __init__(self, rid, tenant="default", weight=1.0):
        self.request_id, self.tenant, self.weight = rid, tenant, weight


@pytest.mark.parametrize("seed", range(5))
def test_fair_queue_matches_jax_on_seeded_op_sequences(seed):
    """Seeded runs of append (3 tenants, weights 0.5-3), appendleft,
    popleft, remove and set_weight through both queues: the same pops, the
    same lane depths and length after every op, and the port's head is the
    request its next pop returns (the JAX head is not, for a tenant of
    weight < 1: see the test below)."""
    rng = np.random.default_rng(seed)
    ours, theirs = WeightedFairQueue(), JWeightedFairQueue()
    tenants = [("a", 1.0), ("b", 3.0), ("c", 0.5)]
    n = 0
    for _ in range(300):
        op = rng.choice(["append", "append", "append", "appendleft", "popleft", "popleft",
                         "remove", "set_weight"])
        if op in ("append", "appendleft"):
            t, w = tenants[int(rng.integers(3))]
            n += 1
            for q in (ours, theirs):
                getattr(q, op)(_Req(f"q{n}", t, w))
        elif op == "popleft":
            if not ours:
                with pytest.raises(IndexError):
                    ours.popleft()
                continue
            assert ours.popleft().request_id == theirs.popleft().request_id
        elif op == "remove":
            rid = f"q{int(rng.integers(1, n + 2))}"
            a, b = ours.remove(rid), theirs.remove(rid)
            assert (a is None) == (b is None)
        else:
            t, w = tenants[int(rng.integers(3))][0], float(rng.choice([0.5, 1.0, 2.0, 4.0]))
            ours.set_weight(t, w)
            theirs.set_weight(t, w)
        assert ours.lane_depths() == theirs.lane_depths()
        assert len(ours) == len(theirs) and bool(ours) == bool(theirs)
        assert [r.request_id for r in ours] == [r.request_id for r in theirs]
        head = ours.peek()
        nxt = copy.deepcopy(ours).popleft() if ours else None
        assert (head and head.request_id) == (nxt and nxt.request_id)
    with pytest.raises(ValueError):
        ours.set_weight("a", 0.0)


def test_fair_queue_peek_is_the_next_popleft_with_a_sub_unit_weight():
    """Tenant c (weight 0.5) is visited first but has not accrued a whole
    request, so popleft serves a.  The port's peek says so; the JAX
    package's peek returns c's request, the head its engine then sheds
    while popping a's."""
    ours, theirs = WeightedFairQueue(), JWeightedFairQueue()
    for q in (ours, theirs):
        q.append(_Req("c1", "c", 0.5))
        q.append(_Req("a1", "a", 1.0))
    assert ours.peek().request_id == ours[0].request_id == "a1"
    assert theirs.peek().request_id == "c1"  # the reference's mismatch
    pops = []
    while ours:
        head = ours.peek()
        assert ours.popleft() is head
        pops.append(head.request_id)
    assert pops == ["a1", "c1"]
    assert [theirs.popleft().request_id for _ in range(2)] == pops


def test_latency_stat_percentiles_match_jax():
    rng = np.random.default_rng(3)
    ours, theirs = LatencyStat(window=300), JLatencyStat(window=300)
    for v in rng.exponential(0.05, 1000):
        ours.record(float(v))
        theirs.record(float(v))
    assert ours.snapshot() == theirs.snapshot()
    for q in (0, 50, 90, 95, 99, 100):
        for last in (None, 1, 64, 5000):
            assert ours.percentile(q, last=last) == theirs.percentile(q, last=last)
    assert LatencyStat().percentile(50) == 0.0 and LatencyStat().snapshot()["count"] == 0


# ---------------------------------------------------------- SLO-aware policy --


def _fake_stats(stat_cls, rng):
    s = SimpleNamespace(ttft=stat_cls(), itl=stat_cls(), queue_wait=stat_cls(),
                        t_prefill=float(rng.uniform(0.0, 0.5)),
                        prefill_chunks=int(rng.integers(0, 8)))
    s.decode_round_cost = lambda: 0.012
    return s


@pytest.mark.parametrize("kw", [dict(), dict(max_defer_rounds=2, max_quanta=3, recent=8),
                                dict(slo=(0.2, 0.02, 0.5, 0.8))])
def test_slo_policy_decisions_match_jax(kw):
    """400 scripted views and latency samples through both packages' policy:
    the same ``should_prefill``, ``prefill_quanta`` and ``should_shed`` at
    every step (ITL samples around the target, so every branch is taken)."""
    rng = np.random.default_rng(11)
    kw = dict(kw)
    slo = kw.pop("slo", None)
    ours = SLOAwareSwapPolicy(SLOConfig(*slo) if slo else None, **kw)
    theirs = JSLOAwareSwapPolicy(JSLOConfig(*slo) if slo else None, **kw)
    assert ours.prefill_quanta() == theirs.prefill_quanta() == 1  # unbound
    st_t, st_j = _fake_stats(LatencyStat, np.random.default_rng(1)), _fake_stats(
        JLatencyStat, np.random.default_rng(1))
    ours.bind(st_t)
    theirs.bind(st_j)
    decisions = set()
    for i in range(400):
        itl = float(rng.choice([0.005, 0.02, 0.04, 0.06, 0.2]))
        ttft, qw = float(rng.uniform(0, 0.6)), float(rng.uniform(0, 0.3))
        for st in (st_t, st_j):
            st.itl.record(itl)
            st.ttft.record(ttft)
            st.queue_wait.record(qw)
        if i % 37 == 0:
            for st in (st_t, st_j):
                st.prefill_chunks += 1
                st.t_prefill += 0.004
        v = dict(queue_depth=int(rng.integers(0, 10)), free_slots=int(rng.integers(0, 3)),
                 active_slots=int(rng.integers(0, 5)), swap_cost=float(rng.choice([0.0, 0.03])),
                 decode_round_cost=float(rng.choice([0.0, 0.01])),
                 pending_chunks=int(rng.choice([0, 0, 0, 0, 1])),
                 oldest_wait_s=float(rng.uniform(0, 0.4)))
        d = ours.should_prefill(SchedulerView(**v))
        assert d == theirs.should_prefill(JSchedulerView(**v)), i
        assert ours.prefill_quanta() == theirs.prefill_quanta(), i
        wait = float(rng.uniform(0, 0.7))
        assert ours.should_shed(wait) == theirs.should_shed(wait), i
        decisions.add((d, ours.prefill_quanta()))
        if i % 100 == 99:
            ours.reset()
            theirs.reset()
    assert {False, True} <= {d for d, _ in decisions} and max(q for _, q in decisions) > 1


def test_slo_policy_validation_and_registry():
    assert isinstance(make_policy("slo-aware"), SLOAwareSwapPolicy)
    assert make_policy("slo-aware", max_quanta=2).max_quanta == 2
    for bad in (dict(ttft_target_s=0.0), dict(itl_slack=1.5), dict(ttft_risk=0.0)):
        with pytest.raises(ValueError):
            SLOConfig(**bad)
    with pytest.raises(ValueError, match="max_defer_rounds"):
        SLOAwareSwapPolicy(max_quanta=0)
    pol = SLOAwareSwapPolicy(SLOConfig(ttft_target_s=0.2, itl_target_s=0.05))
    assert not pol.should_shed(0.19) and pol.should_shed(0.2) and not pol.should_shed(0.09)


def _shed_run(eng, request_cls):
    eng.submit(request_cls("ok", np.arange(6, dtype=np.int32), max_new=2))
    eng.run()
    doomed = request_cls("doomed", np.arange(6, dtype=np.int32), max_new=2)
    eng.submit(doomed)
    doomed.arrival_time_s -= 1.0  # 1 s past its deadline
    outs = eng.step()
    eng.submit(request_cls("after", np.arange(9, dtype=np.int32), max_new=4))
    eng.run()
    shed = [(o.request_id, o.finished, o.finish_reason, list(o.new_token_ids)) for o in outs]
    return shed, {k: (r.finish_reason, list(r.out_tokens)) for k, r in eng.finished.items()}


def test_shedding_a_backdated_head_matches_jax(tiny):
    """The SLO-aware engine sheds a head 1 s past its 50 ms TTFT target
    (``finish_reason="shed"``, a zero delta), serves the rest, and agrees
    with the JAX engine on the outputs, every stream and ``sheds``."""
    slo = dict(ttft_target_s=0.05, itl_target_s=0.05)
    ours, theirs = _engines(tiny, n_slots=2, max_len=32, prompt_len=8)
    ours.scheduler.policy = SLOAwareSwapPolicy(SLOConfig(**slo))
    theirs.scheduler.policy = JSLOAwareSwapPolicy(JSLOConfig(**slo))
    ours.reset_stats()
    theirs.reset_stats()
    got, want = _shed_run(ours, Request), _shed_run(theirs, JRequest)
    assert got == want
    assert got[0] == [("doomed", True, "shed", [])]
    assert ours.stats.sheds == theirs.stats.sheds == 1
    for rid in ("doomed", "after"):  # the same summary, times aside
        a = request_latency(ours.finished[rid])
        b = j_request_latency(theirs.finished[rid])
        assert set(a) == set(b) and all(a[k] == b[k] for k in ("request_id", "tokens",
                                                              "finish_reason"))
        assert (a["ttft_s"] > 0.0) == (b["ttft_s"] > 0.0) and a["e2e_s"] >= 1.0 * (rid == "doomed")


def test_shedding_under_two_tenants_finishes_each_request_once(tiny):
    """Back-dated requests of a weight-0.5 and a weight-1 tenant, queued
    behind a decoding one, with the tracer on: each shed head is the
    request the queue pops, every stream ends exactly once, and ``sheds``
    counts each doomed request once."""
    slo = SLOConfig(ttft_target_s=0.05, itl_target_s=0.05)
    eng = _engines(tiny, n_slots=1, max_len=32, prompt_len=8)[0]
    eng.scheduler.policy = SLOAwareSwapPolicy(slo)
    eng.reset_stats()
    TRACER.enable(capacity=4096)
    try:
        eng.submit(Request("live", np.arange(6, dtype=np.int32), max_new=8))
        outs = eng.step()  # "live" decodes in the only slot
        for rid, tenant, weight in (("c1", "c", 0.5), ("a1", "a", 1.0), ("c2", "c", 0.5),
                                    ("a2", "a", 1.0)):
            req = Request(rid, np.arange(5, dtype=np.int32), max_new=2, tenant=tenant,
                          weight=weight)
            eng.submit(req)
            req.arrival_time_s -= 1.0
        while eng.has_unfinished():
            outs.extend(eng.step())
        done = [o.request_id for o in outs if o.finished]
        trace = TRACER.chrome_trace()
    finally:
        TRACER.disable()
        TRACER.clear()
    assert sorted(done) == ["a1", "a2", "c1", "c2", "live"] and len(done) == len(set(done))
    assert eng.stats.sheds == 4 and len(eng.scheduler.queue) == 0
    assert {rid: eng.finished[rid].finish_reason for rid in done} == {
        "live": "length", "a1": "shed", "a2": "shed", "c1": "shed", "c2": "shed"}
    sheds = [e["args"]["request_id"] for e in trace["traceEvents"] if e["name"] == "req.shed"]
    assert sorted(sheds) == ["a1", "a2", "c1", "c2"]


@pytest.mark.parametrize("policy", ["drain", "swap-aware"])
def test_static_policies_never_shed(tiny, policy):
    for eng, request_cls in zip(_engines(tiny, n_slots=2, max_len=32, prompt_len=8,
                                         swap_policy=policy), (Request, JRequest)):
        req = request_cls("r", np.arange(6, dtype=np.int32), max_new=2)
        eng.submit(req)
        req.arrival_time_s -= 100.0
        eng.run()
        assert eng.finished["r"].finish_reason == "length" and eng.stats.sheds == 0


class _Quanta(SLOAwareSwapPolicy):
    """The SLO-aware policy with its chunk width fixed (the measured one
    depends on wall time)."""

    def prefill_quanta(self):
        return 3


class _JQuanta(JSLOAwareSwapPolicy):
    def prefill_quanta(self):
        return 3


def test_prefill_quanta_widen_chunks_as_jax(tiny):
    """A policy granting 3 chunk quanta a step: both engines run the same
    chunks each step (never more than 3, a decode round after them) and
    give the same streams as the one-chunk engine."""
    kw = dict(n_slots=2, max_len=64, prompt_len=16, cache_layout="paged", block_size=8,
              num_blocks=24, prefill_chunk=8)
    reqs = _requests(n=3, lo=20, hi=40, seed=5)
    runs = {}
    loose = dict(ttft_target_s=1e6, itl_target_s=1e6)  # nothing is shed, whatever the clock
    for name, pol_t, pol_j in (("wide", _Quanta(SLOConfig(**loose)),
                                _JQuanta(JSLOConfig(**loose))), ("one", None, None)):
        ours, theirs = _engines(tiny, **kw)
        if pol_t is not None:
            ours.scheduler.policy, theirs.scheduler.policy = pol_t, pol_j
            ours.reset_stats()
            theirs.reset_stats()
        per_step = []
        for eng, request_cls in ((ours, Request), (theirs, JRequest)):
            for rid, prompt, max_new in reqs:
                eng.submit(request_cls(rid, prompt.copy(), max_new=max_new))
            chunks = []
            while eng.has_unfinished():
                before = eng.stats.prefill_chunks
                eng.step()
                chunks.append(eng.stats.prefill_chunks - before)
            per_step.append(chunks)
        assert per_step[0] == per_step[1]
        runs[name] = ({k: r.out_tokens for k, r in ours.finished.items()},
                      {k: r.out_tokens for k, r in theirs.finished.items()}, per_step[0])
    assert runs["wide"][0] == runs["wide"][1] == runs["one"][0] == runs["one"][1]
    assert max(runs["wide"][2]) == 3 and max(runs["one"][2]) == 1
    assert len(runs["wide"][2]) < len(runs["one"][2])


# -------------------------------------------------------------- AsyncEngine --


@pytest.mark.parametrize("kv_dtype", ["fp", "int8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_async_streams_match_sync_and_jax(tiny, layout, kv_dtype):
    kw = dict(n_slots=2, max_len=40, prompt_len=12, cache_layout=layout, kv_dtype=kv_dtype)
    if layout == "paged":
        kw.update(block_size=8, num_blocks=16)
    reqs = _requests()
    ours, theirs = _engines(tiny, **kw)
    got = _async_tokens(ours, AsyncEngine, reqs)
    assert got == _async_tokens(theirs, JAsyncEngine, reqs)
    assert got == _sync_tokens(_engines(tiny, **kw)[0], reqs, Request)


@pytest.mark.parametrize("case", ["chunked", "spec"])
def test_async_chunked_and_speculative_streams_match_sync_and_jax(tiny, case):
    kw = dict(n_slots=2, max_len=48, prompt_len=16, cache_layout="paged", block_size=8,
              num_blocks=24)
    if case == "chunked":
        kw.update(prompt_len=24, prefill_chunk=8)
        reqs = _requests(lo=12, hi=24, seed=1)
    else:
        kw.update(spec_decode=2)
        base = np.arange(8, dtype=np.int32) % 5 + 3
        reqs = [(f"r{i}", np.tile(base, 2), 10) for i in range(3)]
    ours, theirs = _engines(tiny, **kw)
    got = _async_tokens(ours, AsyncEngine, reqs)
    assert got == _async_tokens(theirs, JAsyncEngine, reqs)
    assert got == _sync_tokens(_engines(tiny, **kw)[0], reqs, Request)
    if case == "spec":
        assert ours.stats.verify_rounds > 0
        assert (ours.stats.draft_tokens, ours.stats.accepted_tokens) == (
            theirs.stats.draft_tokens, theirs.stats.accepted_tokens)


def test_two_tenants_stream_the_single_tenant_tokens(tiny):
    """Weighted fair queueing reorders service, not tokens; the per-tenant
    queue waits are kept, under the same tenants as the JAX engine's."""
    kw = dict(n_slots=2, max_len=40, prompt_len=12)
    reqs = _requests(n=4)
    tenants = [("interactive", 2.0), ("batch", 1.0)]
    ours, theirs = _engines(tiny, **kw)
    got = _async_tokens(ours, AsyncEngine, reqs, tenants=tenants)
    assert got == _async_tokens(theirs, JAsyncEngine, reqs, tenants=tenants)
    assert got == _sync_tokens(_engines(tiny, **kw)[0], reqs, Request)
    waits = ours.stats.tenant_queue_wait
    assert sorted(waits) == sorted(theirs.stats.tenant_queue_wait) == ["batch", "interactive"]
    assert {t: w.count for t, w in waits.items()} == {"batch": 2, "interactive": 2}


def _rejections(core, async_cls, rejected_cls):
    async def go():
        eng = async_cls(core, max_queue=2)  # not started: nothing drains
        prompt = np.arange(6, dtype=np.int32)
        await eng.submit(prompt, request_id="a", max_new=2)
        reasons = []
        for rid, p in (("a", prompt), ("big", np.arange(64, dtype=np.int32))):
            eng.max_queue = 8
            try:
                await eng.submit(p, request_id=rid, max_new=4)
            except rejected_cls as e:
                reasons.append(e.reason.split(":", 1)[0])
        await eng.submit(prompt, request_id="b", max_new=2)
        eng.max_queue = 2
        try:
            await eng.submit(prompt, request_id="c", max_new=2)
        except rejected_cls as e:
            reasons.append(e.reason.split(":", 1)[0])
        snap = eng.snapshot()["frontend"]
        await eng.shutdown()
        try:
            await eng.submit(prompt, request_id="d", max_new=2)
        except rejected_cls as e:
            reasons.append(e.reason.split(":", 1)[0])
        return reasons, snap, eng.reject_reasons

    return asyncio.run(go())


def test_rejections_match_jax(tiny):
    """Duplicate id, a request over max_len, a full queue and a closed
    engine: the same reasons and counters as the JAX front end."""
    ours, theirs = _engines(tiny, n_slots=2, max_len=32, prompt_len=8)
    got = _rejections(ours, AsyncEngine, AdmissionRejected)
    assert got == _rejections(theirs, JAsyncEngine, JAdmissionRejected)
    assert got[0] == ["duplicate_id", "invalid", "queue_full", "shutdown"]
    assert got[2] == {"duplicate_id": 1, "invalid": 1, "queue_full": 1}
    assert got[1]["pending"] == 2 and got[1]["rejected"] == 3


def _abort_everywhere(eng, request_cls):
    """Aborts mid-chunked-prefill, mid-decode, while queued, and (on a
    speculative engine) mid-verify; returns the terminal outputs."""
    outs = []
    eng.submit(request_cls("long", np.arange(24, dtype=np.int32) % 64, max_new=4))
    eng.step()
    assert eng._prefilling
    outs.append(eng.abort("long"))
    eng.submit(request_cls("live", np.arange(9, dtype=np.int32), max_new=16))
    eng.submit(request_cls("other", np.arange(5, 14, dtype=np.int32), max_new=16))
    eng.submit(request_cls("waiting", np.arange(9, dtype=np.int32), max_new=16))
    while len(eng.scheduler.inflight) < 2:
        eng.step()
    outs += [eng.abort("waiting"), eng.abort("live"), eng.abort("other")]
    assert eng.abort("live") is None and not eng.has_unfinished()
    return [(o.request_id, o.finished, o.finish_reason, list(o.token_ids)) for o in outs]


def test_aborts_everywhere_match_jax_and_return_every_page(tiny):
    kw = dict(n_slots=2, max_len=48, prompt_len=24, cache_layout="paged", block_size=8,
              num_blocks=24, prefill_chunk=8)
    ours, theirs = _engines(tiny, **kw)
    free0 = ours.runner.paged.pool.num_free
    got = _abort_everywhere(ours, Request)
    assert got == _abort_everywhere(theirs, JRequest)
    assert [g[2] for g in got] == ["abort"] * 4
    assert ours.stats.aborts == theirs.stats.aborts == 4
    assert ours.runner.paged.pool.num_free == free0 and ours.runner.paged.pool.num_live == 0


def _abort_mid_verify(eng, request_cls):
    base = np.arange(8, dtype=np.int32) % 5 + 3
    eng.submit(request_cls("spec", np.tile(base, 2), max_new=24))
    eng.submit(request_cls("other", np.arange(10, dtype=np.int32), max_new=6))
    while eng.stats.verify_rounds < 1 and eng.has_unfinished():
        eng.step()
    out = eng.abort("spec")
    eng.run()
    return (list(out.token_ids), out.finish_reason, eng.finished["other"].out_tokens)


def test_abort_mid_verify_matches_jax(tiny):
    """On an int8 cache: over bf16 the JAX verify pass rounds q and the
    probabilities to bf16 where its decode steps (and the port) do not, so
    the streams after a verify round can part there (ROADMAP C)."""
    ours, theirs = _engines(tiny, n_slots=2, max_len=48, prompt_len=24, cache_layout="paged",
                            block_size=8, num_blocks=24, spec_decode=2, kv_dtype="int8")
    free0 = ours.runner.paged.pool.num_free
    got = _abort_mid_verify(ours, Request)
    assert got == _abort_mid_verify(theirs, JRequest) and got[1] == "abort"
    assert ours.runner.paged.pool.num_free == free0


def _stream_abort(core, async_cls):
    async def go():
        async with async_cls(core) as eng:
            stream = await eng.submit(np.arange(8, dtype=np.int32), request_id="x", max_new=48)
            queued = await eng.submit(np.arange(5, dtype=np.int32), request_id="y", max_new=4)
            await queued.abort()  # aborted before (or just as) it reaches the engine
            outs = []
            async for out in stream:
                outs.append(out)
                if len(outs) == 1:
                    await stream.abort()
            last = [o async for o in queued][-1]
        return outs, last, core.stats.aborts

    return asyncio.run(go())


def test_stream_abort_ends_with_an_abort_delta(tiny):
    ours, theirs = _engines(tiny, n_slots=2, max_len=64, prompt_len=8)
    outs, last, aborts = _stream_abort(ours, AsyncEngine)
    assert outs[-1].finished and outs[-1].finish_reason == "abort"
    assert sum(len(o.new_token_ids) for o in outs) < 48
    assert last.finish_reason == "abort" and aborts == 2
    jouts, jlast, jaborts = _stream_abort(theirs, JAsyncEngine)
    assert [o.finish_reason for o in outs][-1] == jouts[-1].finish_reason
    assert (last.finish_reason, aborts) == (jlast.finish_reason, jaborts)


def test_request_fields_keep_their_order():
    """``tenant`` and ``weight`` come after ``params``, as in the JAX
    ``Request``: every earlier construction, positional or by keyword,
    means what it meant."""
    r = Request("a", np.arange(3), 4, 2, SamplingParams(temperature=0.5))
    assert (r.priority, r.params.temperature, r.tenant, r.weight) == (2, 0.5, "default", 1.0)
    ours = [f.name for f in Request.__dataclass_fields__.values()]
    theirs = [f.name for f in JRequest.__dataclass_fields__.values()]
    assert ours[:7] == theirs[:7] == ["request_id", "prompt", "max_new", "priority", "params",
                                      "tenant", "weight"]


# ------------------------------------------------------------------- HTTP --


def test_tenants_are_capped_and_weights_checked(tiny):
    """A client rotating tenant names: past ``max_tenants`` distinct ones
    every new name is refused (``tenant_limit``; ``400`` over HTTP, where a
    retry cannot help), known tenants still get in, and the queue's lanes,
    the per-tenant waits and the metric label sets stay within the cap.  A
    weight that is not finite and positive is ``invalid``."""
    core = _engines(tiny, n_slots=2, max_len=32, prompt_len=8)[0]
    prompt = np.arange(5, dtype=np.int32)

    async def go():
        reasons = []
        async with AsyncEngine(core, max_queue=512, max_tenants=8) as eng:
            streams = []
            for i in range(200):
                try:
                    streams.append(await eng.submit(prompt, max_new=1, tenant=f"t{i}"))
                except AdmissionRejected as e:
                    reasons.append(e.reason.split(":", 1)[0])
            streams.append(await eng.submit(prompt, max_new=1, tenant="t3"))
            for w in (0.0, -1.0, float("nan"), float("inf")):
                with pytest.raises(AdmissionRejected, match="^invalid: tenant weight"):
                    await eng.submit(prompt, max_new=1, tenant="t3", weight=w)
            for st in streams:
                async for out in st:
                    pass
                assert out.finish_reason == "length"
            text = eng.metrics_registry().prometheus_text()
        return reasons, text

    reasons, text = asyncio.run(go())
    assert reasons == ["tenant_limit"] * 192
    assert len(core.scheduler.queue._order) == len(core.stats.tenant_queue_wait) == 8
    labels = {ln.split('tenant="')[1].split('"')[0] for ln in text.splitlines()
              if 'tenant="' in ln}
    assert labels == {f"t{i}" for i in range(8)}

    async def http():
        ready, stop = asyncio.Event(), asyncio.Event()
        port = _free_port()
        task = asyncio.create_task(serve.serve_http(core, SamplingParams(), "127.0.0.1", port,
                                                    max_tenants=1, ready=ready, stop=stop))
        await asyncio.wait_for(ready.wait(), 30)
        got = []
        for tenant in ("a", "b", "a"):
            body = json.dumps({"prompt": [1, 2, 3], "max_new": 2, "tenant": tenant}).encode()
            status, _, payload = await _request(port, "POST", "/generate", body)
            got.append((status.split()[1], payload.startswith(b"data: ") or
                        json.loads(payload)["error"].split(":", 1)[0]))
        stop.set()
        await asyncio.wait_for(task, 60)
        return got

    assert asyncio.run(http()) == [("200", True), ("400", "tenant_limit"), ("200", True)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _request(port, method, path, body=b""):
    """One HTTP exchange on a fresh connection: (status, headers, payload)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    data = await reader.read()
    writer.close()
    with contextlib.suppress(ConnectionResetError, BrokenPipeError):
        await writer.wait_closed()
    head, _, payload = data.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
    return lines[0], headers, payload


async def _open_stream(port, max_new):
    """Start a generate stream and wait for its first SSE delta."""
    body = json.dumps({"prompt": list(range(3, 9)), "max_new": max_new}).encode()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"POST /generate HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    while True:
        line = await asyncio.wait_for(reader.readline(), 30)
        if line.startswith(b"data: "):
            return reader, writer, line


def _sse_events(raw):
    return [json.loads(chunk[len(b"data: "):])
            for chunk in raw.split(b"\n\n") if chunk.startswith(b"data: ")]


def _metric(text, name):
    for line in text.splitlines():
        if line.startswith(name + " ") or line.startswith(name + "{"):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} not in /metrics")


def _http_session(core, serve_http, sampling):
    """Two generates (one with a tenant and sampling fields), a 429, 400 and
    404, /stats, /stats/v2 and /metrics before and after."""

    async def go():
        ready, stop = asyncio.Event(), asyncio.Event()
        port = _free_port()
        task = asyncio.create_task(serve_http(core, sampling(), "127.0.0.1", port,
                                              max_queue=1, ready=ready, stop=stop))
        await asyncio.wait_for(ready.wait(), 30)
        out = {}
        status, headers, payload = await _request(port, "GET", "/metrics")
        out["metrics_type"] = headers["content-type"]
        v0 = _metric(payload.decode(), "repro_decode_tokens_total")
        bodies = [{"prompt": list(range(3, 11)), "max_new": 6, "request_id": "h0"},
                  {"prompt": [5, 1, 7, 2, 9], "max_new": 5, "request_id": "h1",
                   "tenant": "batch", "weight": 2.0, "temperature": 0.0, "top_k": 0}]
        events = []
        for b in bodies:
            status, headers, payload = await _request(port, "POST", "/generate",
                                                      json.dumps(b).encode())
            assert status.startswith("HTTP/1.1 200"), status
            assert headers["content-type"] == "text/event-stream"
            events.append(_sse_events(payload))
        out["events"] = events
        # the held stream takes the one slot; of two generates sent now, the
        # first waits in the queue (max_queue 1) and the second is a 429
        reader, writer, head = await _open_stream(port, max_new=30)
        body = json.dumps({"prompt": [1, 2, 3], "max_new": 4}).encode()
        r1 = asyncio.create_task(_request(port, "POST", "/generate", body))
        r2 = asyncio.create_task(_request(port, "POST", "/generate", body))
        statuses = sorted([(await r1)[0], (await r2)[0]])
        out["busy"] = [s.split()[1] for s in statuses]
        events = _sse_events(head + await asyncio.wait_for(reader.read(), 60))
        writer.close()
        out["held"] = (events[-1]["finish_reason"], sum(len(e["new_token_ids"]) for e in events))
        out["bad"] = [(await _request(port, m, p, b))[0].split()[1] for m, p, b in (
            ("POST", "/generate", b"{not json"), ("POST", "/generate", b'{"max_new": 3}'),
            ("GET", "/nope", b""))]
        status, _, payload = await _request(port, "GET", "/stats")
        out["stats"] = json.loads(payload)
        status, _, payload = await _request(port, "GET", "/stats/v2")
        out["v2"] = json.loads(payload)
        status, _, payload = await _request(port, "GET", "/metrics")
        out["metrics"] = (v0, payload.decode())
        stop.set()
        out["rc"] = await asyncio.wait_for(task, 60)
        return out

    return asyncio.run(go())


def test_http_server_matches_jax(tiny):
    """The same exchanges against both servers: the same SSE events, one
    429 while the queue (max 1) is full, 400/400/404, /stats with the
    front end's counters and both tenants, /stats/v2, and /metrics in the
    Prometheus content type with monotonic counters equal to the stats."""
    ours, theirs = _engines(tiny, n_slots=1, max_len=64, prompt_len=8)
    got = _http_session(ours, serve.serve_http, SamplingParams)
    want = _http_session(theirs, jserve.serve_http, JSamplingParams)
    assert got["events"] == want["events"]
    assert [e["finish_reason"] for e in got["events"][0]][-1] == "length"
    assert got["busy"] == want["busy"] and "429" in got["busy"]
    assert got["held"] == want["held"] == ("length", 30)
    assert got["bad"] == want["bad"] == ["400", "400", "404"]
    assert got["metrics_type"] == want["metrics_type"] == PROMETHEUS_CONTENT_TYPE
    fe, jfe = got["stats"]["frontend"], want["stats"]["frontend"]
    assert fe == jfe and fe["accepted"] == 4 and fe["reject_reasons"] == {"queue_full": 1}
    assert sorted(got["stats"]["tenants"]) == sorted(want["stats"]["tenants"]) == [
        "batch", "default"]
    for key in ("decode_tokens", "prefill_tokens", "swaps", "aborts", "sheds"):
        assert got["stats"][key] == want["stats"][key]
    v0, text = got["metrics"]
    assert _metric(text, "repro_decode_tokens_total") == got["stats"]["decode_tokens"] > v0
    assert _metric(text, "repro_frontend_accepted_total") == 4.0
    assert _metric(text, "repro_frontend_rejected_total") == 1.0
    assert 'repro_roofline_residency_ratio{phase="decode"}' in text
    assert got["v2"]["schema"] == "v2" and set(got["v2"]) == set(want["v2"])
    assert got["v2"]["counters"]["repro_frontend_accepted_total"] == 4.0
    assert got["rc"] == want["rc"] == 0


def test_graceful_drain_finishes_inflight_and_rejects_new(tiny):
    """stop -> draining: a new generate answers 503, /stats stays up, and
    the open stream runs to its end inside the grace window."""
    cfg_j, params_j, cfg_t, params_t = tiny

    async def go():
        core = EngineCore(cfg_t, params_t, n_slots=2, max_len=256, prompt_len=8, device="cpu")
        ready, stop = asyncio.Event(), asyncio.Event()
        port = _free_port()
        task = asyncio.create_task(serve.serve_http(core, SamplingParams(), "127.0.0.1", port,
                                                    ready=ready, stop=stop, grace_s=60.0))
        await asyncio.wait_for(ready.wait(), 30)
        reader, writer, head = await _open_stream(port, max_new=200)
        stop.set()
        await asyncio.sleep(0.05)
        status, _, payload = await _request(port, "POST", "/generate",
                                            json.dumps({"prompt": [1, 2]}).encode())
        assert status.startswith("HTTP/1.1 503") and b"draining" in payload
        status, _, payload = await _request(port, "GET", "/stats")
        assert status.startswith("HTTP/1.1 200")
        assert json.loads(payload)["frontend"]["open_streams"] >= 1
        events = _sse_events(head + await asyncio.wait_for(reader.read(), 60))
        assert events[-1]["finished"] and events[-1]["finish_reason"] == "length"
        assert sum(len(e["new_token_ids"]) for e in events) == 200
        writer.close()
        assert await asyncio.wait_for(task, 60) == 0

    asyncio.run(go())


def test_grace_deadline_aborts_the_open_stream(tiny):
    """grace 0: the engine aborts the open stream at the deadline, before
    the listening server's exit waits for its connection, so the client
    reads a terminal ``"abort"`` delta well before its 240 tokens.  (The
    JAX server leaves the server's context first, and on Python >= 3.12.1
    that waits for the stream to run to its end.)"""
    cfg_j, params_j, cfg_t, params_t = tiny

    async def go():
        core = EngineCore(cfg_t, params_t, n_slots=2, max_len=256, prompt_len=8, device="cpu")
        ready, stop = asyncio.Event(), asyncio.Event()
        port = _free_port()
        task = asyncio.create_task(serve.serve_http(core, SamplingParams(), "127.0.0.1", port,
                                                    ready=ready, stop=stop, grace_s=0.0))
        await asyncio.wait_for(ready.wait(), 30)
        reader, writer, head = await _open_stream(port, max_new=240)
        stop.set()
        events = _sse_events(head + await asyncio.wait_for(reader.read(), 60))
        assert events[-1]["finished"] and events[-1]["finish_reason"] == "abort"
        assert sum(len(e["new_token_ids"]) for e in events) < 240
        writer.close()
        assert await asyncio.wait_for(task, 60) == 0
        assert core.stats.aborts == 1 and not core.has_unfinished()

    asyncio.run(go())


# -------------------------------------------------------------------- CLI --


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    text = buf.getvalue()
    return [ln.strip() for ln in text.splitlines() if ln.strip().startswith("req-")], text


def _jax_kernel_path_main(argv):
    """The JAX CLI on its kernel path: its config with ``use_pallas=True``
    (the Pallas kernels in interpret mode), as every parity test runs it.
    Its default jnp paths (a dense prefill attention, a decode that casts
    q to the cache's bf16) round otherwise; the port follows the kernels
    (ROADMAP C)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserve, "reduced_config",
                   functools.partial(jcfgs.reduced_config, use_pallas=True))
        return jserve.main(argv)


@pytest.mark.parametrize("extra", [[], ["--cache-layout", "paged", "--ragged"],
                                   ["--arrival-every", "2", "--swap-policy", "swap-aware"]])
def test_cli_prints_the_jax_clis_tokens(extra, tmp_path):
    """``python -m repro_torch.launch.serve --reduced --device cpu`` prints
    the JAX CLI's tokens for each request, from the same --seed (the JAX
    init's weights, latent, quantized on the fly), greedy; with
    ``--trace-out`` it writes a Chrome trace."""
    args = ["--arch", "bitnet-730m", "--reduced", "--requests", "4", "--prompt-len", "16",
            "--max-new", "6", "--max-len", "64"] + extra
    trace = tmp_path / "trace.json"
    try:
        got, text = _printed(serve.main, args + ["--device", "cpu", "--trace-out", str(trace)])
    finally:  # the CLI leaves the process-wide tracer on
        TRACER.disable()
        TRACER.clear()
    want, _ = _printed(_jax_kernel_path_main, args)
    assert got == want and len(got) == 3
    assert "requests finished : 4/4" in text
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"req.submit", "req.admit", "prefill", "decode.round", "req.finish"} <= names


def test_cli_refuses_disagg_and_runs_on_cuda_unless_told():
    # --disagg is no longer refused: both pools share the one device
    got, text = _printed(serve.main, ["--reduced", "--device", "cpu", "--disagg", "--requests",
                                      "2", "--prompt-len", "8", "--max-new", "2",
                                      "--max-len", "32"])
    assert "colocating both pools" in text and "KV handoff        : 2 segments" in text
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--requests", "1"])
