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

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.mesh import BACKENDS, join_process_group, make_host_mesh
from repro_torch.launch.sharding_rules import shard_params
from repro_torch.models import transformer as T
from repro_torch.serving import DisaggEngine, EngineCore, Request
from repro_torch.serving.disagg import make_disagg_meshes


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
            if not same:
                return 1
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
