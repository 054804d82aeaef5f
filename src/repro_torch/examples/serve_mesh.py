"""Serve a model on a mesh of processes, one rank a process.

Start the ranks with the launcher, which sets RANK, WORLD_SIZE and the
store's address; name the backend (``nccl`` on cards, ``gloo`` anywhere):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.examples.serve_mesh --backend gloo --data 2 --model 2
    # on the CPU, a reduced model, checked against the unsharded engine:
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.examples.serve_mesh --backend gloo --device cpu --reduced --check

``--prefill-chunk``, ``--spec-decode`` and ``--swap-policy`` take the
engine's options on any mesh (rank 0's policy decides for every rank):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.examples.serve_mesh --backend gloo --device cpu --reduced --check \\
        --cache-layout paged --kv-dtype int8 --prefill-chunk 16 --spec-decode 2 \\
        --swap-policy swap-aware

With ``--disagg`` the world is the pod split of the disaggregated pools
instead: a (pod 2, model ``--model``) mesh, pod 0 prefilling, pod 1
decoding, every prompt's KV crossing between them (``DisaggEngine``; the
world must have ``2 * --model`` ranks, and ``--check`` compares with the
two pools on one device):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.examples.serve_mesh --backend gloo --model 2 --disagg \\
        [--device cpu --reduced --check --prefill-chunk 16 --cache-layout paged]

``--arch hymba-1.5b``, ``xlstm-1.3b`` or ``whisper-large-v3`` serves that
family through its phase programs (``PhaseEngine.prefill_program``,
``install_program``, ``decode_program``): the requests prefilled as one
batch (whisper's frames drawn from ``--seed``), installed into as many
slots, and decoded greedily; ``--long-context`` decodes hymba at batch 1
under the long-context rules (the KV sequence over data x model, the SSM's
channels over model):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.examples.serve_mesh --backend gloo --device cpu --reduced --check \\
        --arch hymba-1.5b [--long-context]

Rank r lives on ``cuda:(r % device_count)``: on a machine with one card
every rank shares ``cuda:0``.  Every rank builds the same weights from
``--seed``, keeps its slice and drops the whole tree (``--check`` keeps it
on rank 0 for the unsharded engine); rank 0 admits the requests and prints the
streams, the other ranks follow it.  Each rank prints where it lives and
its KV bytes.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.tree import leaves
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.phase_engine import PhaseEngine
from repro_torch.launch.mesh import BACKENDS, join_process_group, make_host_mesh
from repro_torch.launch.sharding_rules import shard_params
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.serving import DisaggEngine, EngineCore, Request
from repro_torch.serving.disagg import make_disagg_meshes


def tree_mib(tree) -> float:
    return sum(t.numel() * t.element_size() for t in leaves(tree)) / 2**20


def serve_family(eng: PhaseEngine, params, prompts, max_new: int, max_len: int, frames=None,
                 on_step=None, dtype=None, feed=None):
    """Greedy streams of a hymba, xlstm or whisper ``eng`` (on its mesh or
    none) from a fresh cache of B slots (in ``dtype``, or the family's
    own: a bf16 KV, xLSTM's f32 states): ``prompts``
    (B, S) prefilled as one batch (``frames`` (B, Senc, d) for whisper) and
    installed into slots 0..B-1, or a list of B prompts of their own
    lengths, each prefilled alone into its slot; then ``max_new - 1``
    decode steps, each fed the last step's greedy token (or ``feed[t]``
    (B,) where given).  Returns (the greedy tokens (max_new, B), the
    cache); ``on_step(i, logits)`` sees each step's logits (the prefill's
    at 0)."""
    dev = leaves(params)[0].device
    batched = isinstance(prompts, np.ndarray)
    b = len(prompts)
    cache = eng.init_cache(b, max_len, device=dev, dtype=dtype)
    with torch.no_grad():
        rows = [np.asarray(prompts)] if batched else [p[None] for p in prompts]
        firsts = []
        for i, row in enumerate(rows):
            tokens = torch.from_numpy(row).long().to(dev)
            s = tokens.shape[1]
            args = (tokens,) if frames is None else (tokens, frames if batched else frames[i:i + 1])
            logits, pre = eng.prefill_program(len(row), s, frames=frames is not None)(params, *args)
            eng.install_program(len(row), s, max_len)(pre, cache,
                                                      list(range(b)) if batched else [i])
            firsts.append(logits)
            del pre
        logits = torch.cat(firsts)
        lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
        dec = eng.decode_program(b, max_len)
        out = []
        for i in range(max_new):
            if on_step is not None:
                on_step(i, logits)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            if i + 1 < max_new:
                fed = tok if feed is None else torch.as_tensor(feed[i], device=dev)
                logits, cache = dec(params, fed, cache, lengths + i)
    return torch.stack(out).cpu().numpy(), cache


def _family_main(args, mesh, cfg) -> int:
    """``--arch`` of another family: serve_family on the mesh, rank 0's
    streams printed (and with ``--check`` compared with one device's)."""
    dev = mesh.device
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    whole = get_model(cfg).init(cfg, args.seed, device=dev, dtype=dtype)
    params = shard_params(whole, cfg, mesh)
    if not (args.check and mesh.rank == 0):
        del whole
    n = 1 if args.long_context else args.requests
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (n, args.prompt_len)).astype(np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = torch.from_numpy(rng.standard_normal((n, cfg.encoder_seq, cfg.d_model))
                                  .astype(np.float32)).to(dev, dtype)
    eng = PhaseEngine(cfg, mesh, long_context=args.long_context)
    streams, cache = serve_family(eng, params, prompts, args.max_new, args.max_len, frames)
    print(f"rank {mesh.rank}: params {tree_mib(params):.2f} MiB, cache {tree_mib(cache):.2f} MiB",
          flush=True)
    same = True
    if mesh.rank == 0:
        for i in range(n):
            print(f"req{i}: {streams[:, i].tolist()}")
        if args.check:
            ref, _ = serve_family(PhaseEngine(cfg, long_context=args.long_context), whole,
                                  prompts, args.max_new, args.max_len, frames)
            same = bool((ref == streams).all())
            print(f"streams {'equal' if same else 'differ from'} the one-device run's")
    return _leave(same)


def _leave(ok: bool) -> int:
    """Every rank leaves the world together: the others wait at a barrier
    while rank 0 checks, so no rank tears its group down while another
    still holds connections to it.  Returns the exit code."""
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=BACKENDS, required=True)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--arch", default="bitnet-730m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-layout", choices=("contiguous", "paged"), default="contiguous")
    ap.add_argument("--kv-dtype", choices=("fp", "int8", "int4"), default="fp")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="rank 0 also serves the requests without a mesh and compares")
    ap.add_argument("--disagg", action="store_true",
                    help="the pod split of the disaggregated pools: (pod 2, model --model)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill (paged: a multiple of 16); with --disagg each chunk "
                         "crosses the pods at once")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decoding draft depth (0 = off): the verify rounds run on "
                         "the mesh (with --disagg on the decode pod)")
    ap.add_argument("--long-context", action="store_true",
                    help="hymba at batch 1 under the long-context decode rules")
    ap.add_argument("--swap-policy", default="drain",
                    choices=("drain", "swap-aware", "slo-aware"),
                    help="the prefill<->decode policy; rank 0 decides for every rank")
    args = ap.parse_args(argv)

    join_process_group(args.backend, device_type=args.device)
    if args.disagg:
        pools = make_disagg_meshes(tp=args.model)
        mesh = next(m for m in pools if hasattr(m, "parent"))  # this rank's pool
    else:
        mesh = make_host_mesh(data=args.data, model=args.model)
    print(mesh.describe(), flush=True)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family != "transformer":
        return _family_main(args, mesh, cfg)
    whole = T.convert_for_inference(T.init(cfg, args.seed, device=mesh.device), cfg)
    params = shard_params(whole, cfg, mesh)  # this rank's slice; the whole tree goes
    if not (args.check and mesh.rank == 0):
        del whole
    kw = dict(n_slots=args.slots, max_len=args.max_len, cache_layout=args.cache_layout,
              kv_dtype=args.kv_dtype, block_size=16, prefill_chunk=args.prefill_chunk,
              spec_decode=args.spec_decode or None, swap_policy=args.swap_policy)
    if args.disagg:
        eng = DisaggEngine(cfg, params, prefill_mesh=pools[0], decode_mesh=pools[1], **kw)
        mesh = eng.mesh  # the world: rank 0 admits
    else:
        eng = EngineCore(cfg, params, mesh=mesh, device=mesh.device, **kw)
    kw["device"] = mesh.device
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]
    if mesh.rank == 0:
        for i, p in enumerate(prompts):
            eng.submit(Request(f"req{i}", p, max_new=args.max_new))
        eng.run()
        eng.stop_followers()
    else:
        eng.follow()
    print(f"rank {mesh.rank}: KV {eng.kv_bytes()['allocated'] / 2**20:.2f} MiB, "
          f"{eng.stats.decode_rounds} decode rounds", flush=True)
    same = True
    if mesh.rank == 0:
        streams = {r: q.out_tokens for r, q in sorted(eng.finished.items())}
        for rid, toks in streams.items():
            print(f"{rid}: {toks}")
        if args.check:
            ref = (DisaggEngine if args.disagg else EngineCore)(cfg, whole, **kw)
            for i, p in enumerate(prompts):
                ref.submit(Request(f"req{i}", p, max_new=args.max_new))
            ref.run()
            same = streams == {r: q.out_tokens for r, q in sorted(ref.finished.items())}
            print(f"streams {'equal' if same else 'differ from'} the unsharded engine's"
                  + (" (both pools on one device)" if args.disagg else ""))
    return _leave(same)


if __name__ == "__main__":
    raise SystemExit(main())
