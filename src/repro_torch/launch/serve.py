"""Serving entry point of the port: the step-driven engine under a synthetic
load, or behind an HTTP/SSE server.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --requests 8 --swap-policy slo-aware [--device cpu --reduced]

``--arch`` takes every architecture of the JAX registry, as the JAX CLI
does (its default, ``smollm-135m``, is the default here too); the engine
drives the transformer family, dense and MoE, and refuses the others with
the JAX CLI's message.

The port of the JAX package's ``repro.launch.serve``, with its arguments,
its printout, its routes, status codes, JSON bodies and SSE events.  It
drives ``EngineCore.step()`` (the paper's temporal logic swap, or the
static baseline with ``--mode static``) with per-request ``SamplingParams``
and a swap policy, and prints the per-phase stats, the measured overlap of
the swap, TTFT, queue wait, ITL, roofline drift on the port's card and the
first requests' tokens.  Requests arrive on a seeded Poisson process
(``--arrival-rate R`` a second) or one every N steps (``--arrival-every``).

The weights are the JAX CLI's: latent f32, drawn from ``--seed`` as
``transformer.init(cfg, PRNGKey(seed), float32)`` draws them
(``models.jax_init``), not packed, so under a ternary arch every linear
quantizes them on the fly and runs the TLMM kernel.  On the CPU the tokens are the JAX CLI's.  It runs
on the card unless ``--device cpu`` is given, and builds the serving grid
there (every program built, the decode, chunk and sampler programs captured
as CUDA graphs) before serving.

With ``--serve`` the engine runs behind an HTTP front end on asyncio
streams: ``POST /generate`` streams each delta as a server-sent event,
``GET /stats`` returns the engine snapshot as JSON (``GET /stats/v2`` the
typed registry), ``GET /metrics`` the Prometheus text, and a full admission
queue answers ``429`` with its reason.  ``--trace-out trace.json`` records
the lifecycle and engine spans and writes a Chrome trace on exit.

    PYTHONPATH=src python -m repro_torch.launch.serve --serve --port 8035
    curl -N -d '{"prompt": [3, 1, 4, 1, 5, 9], "max_new": 8}' \\
        http://127.0.0.1:8035/generate
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import signal
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, ModelConfig, get_config, reduced_config
from repro_torch.models.jax_init import init_like_jax
from repro_torch.obs.metrics import PROMETHEUS_CONTENT_TYPE
from repro_torch.obs.trace import TRACER
from repro_torch.serving import (
    POLICIES,
    AdmissionRejected,
    AsyncEngine,
    DisaggEngine,
    EngineCore,
    Request,
    SamplingParams,
)
from repro_torch.serving.arrivals import poisson_times
from repro_torch.serving.core import check_served_family


def _http_payload(writer, status: str, body: bytes, ctype: str = "application/json") -> None:
    writer.write(f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                 f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode() + body)


@dataclasses.dataclass
class ServerState:
    """Shared handler state: once ``draining`` flips, ``POST /generate``
    answers ``503`` while ``GET /stats`` keeps serving."""

    draining: bool = False


async def handle_connection(eng: AsyncEngine, default_params: SamplingParams,
                            reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                            state: Optional[ServerState] = None) -> None:
    """One HTTP exchange on raw asyncio streams.

    ``POST /generate`` takes a JSON body — ``prompt`` (token ids, required),
    optional ``max_new``, ``request_id``, ``tenant``, ``weight``,
    ``temperature``, ``top_k``, ``top_p``, ``seed``, ``stop_tokens`` — and
    streams one server-sent event a ``RequestOutput`` delta; a refused
    admission answers ``429`` with the reason, a bad body or a tenant past
    the engine's ``max_tenants`` ``400``.
    ``GET /stats``, ``/stats/v2`` and ``/metrics`` report the engine."""
    try:
        request_line = await reader.readline()
        parts = request_line.decode("latin-1").split()
        if len(parts) < 2:
            return
        method, path = parts[0], parts[1]
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            key, _, val = line.decode("latin-1").partition(":")
            headers[key.strip().lower()] = val.strip()
        body = b""
        length = int(headers.get("content-length", "0") or 0)
        if length:
            body = await reader.readexactly(length)

        if method == "GET" and path == "/stats":
            _http_payload(writer, "200 OK", json.dumps(eng.snapshot()).encode())
        elif method == "GET" and path == "/stats/v2":
            _http_payload(writer, "200 OK", json.dumps(eng.snapshot_v2()).encode())
        elif method == "GET" and path == "/metrics":
            _http_payload(writer, "200 OK", eng.metrics_registry().prometheus_text().encode(),
                          ctype=PROMETHEUS_CONTENT_TYPE)
        elif method == "POST" and path == "/generate":
            if state is not None and state.draining:
                _http_payload(writer, "503 Service Unavailable", json.dumps(
                    {"error": "shutting down: server is draining"}).encode())
                return
            try:
                spec = json.loads(body or b"{}")
                prompt = np.asarray(spec["prompt"], np.int32)
            except (ValueError, KeyError, TypeError) as e:
                _http_payload(writer, "400 Bad Request",
                              json.dumps({"error": f"bad request body: {e}"}).encode())
                return
            sp = default_params
            if any(k in spec for k in ("temperature", "top_k", "top_p", "seed", "stop_tokens")):
                sp = SamplingParams(
                    temperature=float(spec.get("temperature", default_params.temperature)),
                    top_k=int(spec.get("top_k", default_params.top_k)),
                    top_p=float(spec.get("top_p", default_params.top_p)),
                    seed=int(spec.get("seed", default_params.seed or 0)),
                    stop_tokens=tuple(spec.get("stop_tokens", default_params.stop_tokens)),
                )
            try:
                stream = await eng.submit(prompt, sp, request_id=spec.get("request_id"),
                                          max_new=spec.get("max_new"),
                                          tenant=str(spec.get("tenant", "default")),
                                          weight=float(spec.get("weight", 1.0)))
            except AdmissionRejected as e:
                status = ("400 Bad Request" if e.reason.startswith("tenant_limit")
                          else "429 Too Many Requests")  # a retry cannot help the former
                _http_payload(writer, status, json.dumps({"error": e.reason}).encode())
                return
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                         b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n")
            await writer.drain()
            async for out in stream:
                event = {"request_id": out.request_id, "new_token_ids": list(out.new_token_ids),
                         "finished": out.finished, "finish_reason": out.finish_reason}
                writer.write(b"data: " + json.dumps(event).encode() + b"\n\n")
                await writer.drain()
        else:
            _http_payload(writer, "404 Not Found",
                          json.dumps({"error": f"no route {method} {path}"}).encode())
    except (ConnectionResetError, asyncio.IncompleteReadError):
        pass  # the client went away mid-exchange; the engine keeps its own state
    finally:
        try:
            await writer.drain()
            writer.close()
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass


async def serve_http(core: EngineCore, default_params: SamplingParams, host: str, port: int, *,
                     max_queue: int = 64, max_tenants: int = 64,
                     ready: Optional[asyncio.Event] = None,
                     stop: Optional[asyncio.Event] = None, grace_s: float = 5.0) -> int:
    """Serve the engine over HTTP until asked to stop, then drain.

    ``ready`` is set once the socket listens.  SIGINT or SIGTERM (or
    ``stop``) starts the drain: ``POST /generate`` answers ``503`` (the
    stats stay up), open streams get ``grace_s`` seconds to finish, and at
    the deadline the engine aborts whatever is still open, each stream
    receiving a terminal ``finish_reason="abort"`` delta.  The abort comes
    before the listening server's context closes: on Python >= 3.12.1 that
    exit waits for every open connection, so a stream left running would be
    served to its end first."""
    if stop is None:
        stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    state = ServerState()
    hooked = []
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
            hooked.append(sig)
        except (NotImplementedError, RuntimeError, ValueError):
            pass  # not the main thread, or no loop signal support here
    try:
        async with AsyncEngine(core, max_queue=max_queue, max_tenants=max_tenants) as eng:
            server = await asyncio.start_server(
                lambda r, w: handle_connection(eng, default_params, r, w, state=state),
                host, port)
            bound = server.sockets[0].getsockname()
            print(f"serving on http://{bound[0]}:{bound[1]}  "
                  f"(POST /generate streams SSE, GET /stats, GET /metrics)")
            if ready is not None:
                ready.set()
            async with server:
                try:
                    await stop.wait()
                except asyncio.CancelledError:
                    pass
                state.draining = True
                print(f"draining: rejecting new work (503), waiting up to {grace_s:.1f}s "
                      "for in-flight streams")
                deadline = loop.time() + grace_s
                while loop.time() < deadline and (eng.open_streams or core.has_unfinished()):
                    await asyncio.sleep(0.02)
                await eng.shutdown()  # the deadline's aborts, while the handlers still run
    finally:
        for sig in hooked:
            loop.remove_signal_handler(sig)
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", choices=ALL_ARCHS, default="smollm-135m")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs (the CPU runs the kernels' plain versions)")
    p.add_argument("--mode", default="pdswap", choices=["pdswap", "static"])
    p.add_argument("--cache-layout", default="contiguous", choices=["contiguous", "paged"])
    p.add_argument("--block-size", type=int, default=16, help="tokens a KV page (paged layout)")
    p.add_argument("--num-blocks", type=int, default=None,
                   help="KV pool pages (paged layout; default: every slot can reach max_len)")
    p.add_argument("--kv-dtype", default="fp", choices=["fp", "int8", "int4"],
                   help="KV-cache precision: bf16, or a packed int8/int4 payload with f32 "
                        "scale planes (dequantized inside the decode kernels)")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="tokens a prefill quantum, with a decode round between chunks "
                        "(None: monolithic; paged: a multiple of --block-size)")
    p.add_argument("--spec-decode", type=int, default=0, metavar="K",
                   help="speculative decoding draft depth (prompt lookup; 0 = off)")
    p.add_argument("--spec-ngram", type=int, default=3, metavar="N",
                   help="prompt-lookup n-gram size for --spec-decode")
    p.add_argument("--disagg", action="store_true",
                   help="disaggregated serving: prefill and decode run as two pools (on one "
                        "device: the prefill pool on its own stream and thread) with a KV "
                        "handoff channel between them")
    p.add_argument("--ragged", action="store_true",
                   help="draw prompt lengths uniformly in [4, prompt_len]")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--max-len", type=int, default=128)
    p.add_argument("--no-overlap", action="store_true",
                   help="run the swap after the prefill tail (ablation)")
    p.add_argument("--seed", type=int, default=0,
                   help="seeds the weights, the workload and sampling")
    p.add_argument("--swap-policy", default="drain", choices=sorted(POLICIES),
                   help="prefill<->decode transition policy (paper: drain)")
    p.add_argument("--arrival-every", type=int, default=0,
                   help="submit one request every N steps (0 = all up front; "
                        "ignored when --arrival-rate is set)")
    p.add_argument("--arrival-rate", type=float, default=0.0,
                   help="seeded Poisson arrivals at R requests/s of wall clock "
                        "(0 = use --arrival-every)")
    p.add_argument("--serve", action="store_true",
                   help="run as an HTTP server: POST /generate streams SSE deltas, "
                        "GET /stats returns the engine snapshot")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8035)
    p.add_argument("--max-queue", type=int, default=64,
                   help="server: admission backlog before submits are refused with 429")
    p.add_argument("--max-tenants", type=int, default=64,
                   help="server: distinct tenants admitted over its life (later ones get 400)")
    p.add_argument("--grace", type=float, default=5.0,
                   help="server: seconds open streams may finish after SIGINT/SIGTERM "
                        "before they are aborted")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="record lifecycle and engine spans; write a Chrome trace here on exit")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (0 = greedy, the paper's setting)")
    p.add_argument("--top-k", type=int, default=0, help="top-k truncation (0 = off)")
    p.add_argument("--top-p", type=float, default=1.0, help="nucleus mass (1.0 = off)")
    p.add_argument("--stop-token", type=int, action="append", default=None,
                   help="token id that ends generation (repeatable)")
    return p.parse_args(argv)


def build(args) -> Tuple[ModelConfig, EngineCore, SamplingParams]:
    """The config, the engine on the JAX CLI's weights (its serving grid
    built on a card), and the default sampling parameters."""
    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    check_served_family(cfg)
    # drawn where they are used: a card draws a full-width model in seconds
    params = init_like_jax(cfg, args.seed, device, draw_device=device)
    kw = dict(n_slots=args.slots, max_len=args.max_len, prompt_len=args.prompt_len,
              mode=args.mode, cache_layout=args.cache_layout, block_size=args.block_size,
              num_blocks=args.num_blocks, kv_dtype=args.kv_dtype, overlap=not args.no_overlap,
              swap_policy=args.swap_policy, prefill_chunk=args.prefill_chunk,
              spec_decode=args.spec_decode or None, spec_ngram=args.spec_ngram, device=device)
    if args.disagg:
        # both pools share one device, the prefill pool on its own stream and
        # dispatch thread (the split across two cards is ROADMAP A.8)
        why = ("fewer than 2 local devices" if device.type != "cuda"
               or torch.cuda.device_count() < 2 else "no two-card split in the port yet")
        print(f"disagg: {why}, colocating both pools on {device}")
        eng = DisaggEngine(cfg, params, **kw)
    else:
        eng = EngineCore(cfg, params, **kw)
    if device.type == "cuda":
        eng.build_serving_grid()
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
                        seed=args.seed, stop_tokens=tuple(args.stop_token or ()))
    return cfg, eng, sp


def batch_requests(args, cfg, sp: SamplingParams) -> List[Request]:
    """The batch run's requests, from ``--seed`` as the JAX CLI draws them."""
    rng = np.random.default_rng(args.seed)
    ragged_lo = max(1, min(4, args.prompt_len))
    out = []
    for i in range(args.requests):
        n = int(rng.integers(ragged_lo, args.prompt_len + 1)) if args.ragged else args.prompt_len
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        out.append(Request(f"req-{i}", prompt, max_new=args.max_new, params=sp))
    return out


def _drive(args, eng: EngineCore, pending: List[Request]) -> None:
    if args.arrival_rate > 0.0:
        # seeded Poisson arrivals on the wall clock: submit each request once
        # its instant has passed, sleeping only while the engine is idle
        times = poisson_times(args.arrival_rate, len(pending),
                              np.random.default_rng(args.seed + 1))
        arrivals = list(zip(times.tolist(), pending))
        t0 = time.perf_counter()
        while eng.has_unfinished() or arrivals:
            now = time.perf_counter() - t0
            while arrivals and arrivals[0][0] <= now:
                eng.submit(arrivals.pop(0)[1])
            if eng.has_unfinished():
                eng.step()
            elif arrivals:
                time.sleep(max(0.0, arrivals[0][0] - (time.perf_counter() - t0)))
        return
    if args.arrival_every <= 0:
        for r in pending:
            eng.submit(r)
        pending = []
    step = 0
    while eng.has_unfinished() or pending:
        step += 1
        if pending and (step - 1) % args.arrival_every == 0:
            eng.submit(pending.pop(0))
        eng.step()


def _report(args, eng: EngineCore, sp: SamplingParams) -> None:
    stats = eng.stats
    sampled = "greedy" if sp.greedy else (
        f"T={sp.temperature} top_k={sp.top_k} top_p={sp.top_p} seed={sp.seed}")
    print(f"\nmode={args.mode} overlap={not args.no_overlap} policy={args.swap_policy} "
          f"sampling={sampled} device={eng.device}")
    print(f"  requests finished : {len(eng.finished)}/{args.requests}")
    print(f"  prefill tokens    : {stats.prefill_tokens}  ({stats.t_prefill:.2f}s)")
    print(f"  decode tokens     : {stats.decode_tokens}  ({stats.t_decode:.2f}s, "
          f"{stats.decode_tput():.1f} tok/s on {eng.device})")
    print(f"  logic swaps       : {stats.swaps}  in {stats.prefill_bursts} prefill bursts "
          "(fabric flips)")
    if stats.prefill_chunks:
        print(f"  prefill chunks    : {stats.prefill_chunks}  (chunk={args.prefill_chunk} "
              "tokens, decode interleaved between chunks)")
    if stats.verify_rounds:
        print(f"  speculative decode: k={args.spec_decode} ngram={args.spec_ngram}  "
              f"{stats.accepted_tokens}/{stats.draft_tokens} drafts accepted "
              f"({100 * stats.acceptance_rate():.0f}%), {stats.tokens_per_round():.2f} "
              f"tokens/round over {stats.verify_rounds} verify rounds")
    ttfts = [r.first_token_t - r.arrival_time_s for r in eng.finished.values()
             if r.first_token_t]
    if ttfts:
        print(f"  TTFT              : mean {1e3 * float(np.mean(ttfts)):.1f} ms, "
              f"p max {1e3 * float(np.max(ttfts)):.1f} ms")
    if stats.queue_wait.count:
        print(f"  queue wait        : p50 {1e3 * stats.queue_wait.p50:.1f} ms, "
              f"p95 {1e3 * stats.queue_wait.p95:.1f} ms over {stats.queue_wait.count} "
              "admissions")
    if stats.itl.count:
        print(f"  ITL               : p50 {1e3 * stats.itl.p50:.1f} ms, "
              f"p95 {1e3 * stats.itl.p95:.1f} ms")
    reasons = {}
    for r in eng.finished.values():
        reasons[r.finish_reason] = reasons.get(r.finish_reason, 0) + 1
    print(f"  finish reasons    : {reasons}")
    if args.cache_layout == "paged":
        kb = eng.kv_bytes()
        print(f"  KV pool           : {kb['allocated'] / 2**20:.2f} MiB allocated, "
              f"{kb['peak_in_use'] / 2**20:.2f} MiB peak in use "
              f"(kv_dtype={kb['kv_dtype']}, payload {kb['payload'] / 2**20:.2f} MiB)")
        print(f"  prefix cache      : {stats.prefix_hits} page hits / {stats.prefix_misses} "
              f"misses ({stats.prefix_hit_tokens} tokens reused)")
        print(f"  preemptions       : {stats.preemptions}  admission blocks: "
              f"{stats.admission_blocks}")
    if args.disagg:
        ho = eng.snapshot()["disagg"]["handoff"]
        print(f"  KV handoff        : {ho['segments']} segments ({ho['eager_segments']} eager), "
              f"{ho['bytes_shipped'] / 2**20:.2f} MiB shipped, {ho['installs']} installs")
    if stats.swap_agg.count:
        print(f"  swap latency hidden by overlap: {100 * stats.swap_agg.mean_hidden_fraction:.0f}% "
              f"(paper: ~75%); mean exposed cost {1e3 * stats.swap_agg.mean_cost:.2f} ms")
    for phase, d in eng.snapshot()["roofline_drift"].items():
        print(f"  roofline [{phase:>11}]: measured {1e6 * d['measured_s_per_token']:.2f} us/tok "
              f"vs bound {1e6 * d['bound_s_per_token']:.3f} us/tok "
              f"(residency {d['residency_ratio']:.4f})")
    for rid in sorted(eng.finished)[:3]:
        print(f"  {rid}: {eng.finished[rid].out_tokens[:8]}...")


def _export_trace(path: str, indent: str = "") -> None:
    trace = TRACER.export_chrome_trace(path)
    print(f"{indent}trace: {len(trace['traceEvents'])} events -> {path} "
          f"({TRACER.dropped} dropped)")


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg, eng, sp = build(args)
    if args.trace_out:
        TRACER.enable()
    if args.serve:
        try:
            return asyncio.run(serve_http(eng, sp, args.host, args.port,
                                          max_queue=args.max_queue,
                                          max_tenants=args.max_tenants, grace_s=args.grace))
        except KeyboardInterrupt:
            return 0
        finally:
            if args.trace_out:
                _export_trace(args.trace_out)
    _drive(args, eng, batch_requests(args, cfg, sp))
    _report(args, eng, sp)
    if args.trace_out:
        _export_trace(args.trace_out, indent="  ")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
