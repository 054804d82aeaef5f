"""Train a model on a mesh of processes, one rank a process: FSDP over
``data``, tensor parallelism over ``model``.

Start the ranks with the launcher, which sets RANK, WORLD_SIZE and the
store's address; name the backend (``nccl`` on cards, ``gloo`` anywhere):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.examples.train_mesh --backend gloo --data 2 --model 2
    # on the CPU, a reduced model, checked against the single-device step:
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.examples.train_mesh --backend gloo --device cpu --reduced --check

Rank r lives on ``cuda:(r % device_count)``: on a machine with one card
every rank shares ``cuda:0``.  Every rank draws the same weights from
``--seed``, keeps its FSDP x TP slice and drops the whole tree; each step
takes the pipeline's global batch and each rank trains on its rows.  Rank
0 prints each step's loss and gradient norm; every rank prints the MiB of
its slice of the parameters and moments.  ``--check`` has rank 0 run the
port's single-device step on the same weights and batches and compare.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.common.tree import leaves
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, make_source, with_frames
from repro_torch.launch.mesh import BACKENDS, join_process_group, make_host_mesh
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step

# --check: the mesh's losses and gradient norms against the single device's,
# relative.  A model rank sums a row-parallel product's partial products in
# another order than one device does; in a ternary (W1.58-A8) config a
# residual that moves by an ulp can move an activation across an int8
# rounding step, and the steps carry it on.  Read on the CPU over 3 steps
# of reduced bitnet-730m on (data 2, model 2): at most 8.8e-5
CHECK_RTOL = 1e-3


def _mib(tree) -> float:
    return sum(t.numel() * t.element_size() for t in leaves(tree)) / 2**20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=BACKENDS, required=True)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--arch", default="bitnet-730m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None, help="256, or 32 with --reduced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true",
                    help="rank 0 also takes the steps without a mesh and compares")
    args = ap.parse_args(argv)

    join_process_group(args.backend, device_type=args.device)
    mesh = make_host_mesh(data=args.data, model=args.model)
    print(mesh.describe(), flush=True)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    seq = args.seq or (32 if args.reduced else 256)
    tcfg = TrainConfig(warmup=2, total_steps=max(args.steps, 10))
    source = make_source(DataConfig(batch=args.batch, seq_len=seq, vocab_size=cfg.vocab_size,
                                    seed=args.seed))
    params, opt = init_train_state(cfg, args.seed, mesh=mesh)
    print(f"rank {mesh.rank}: params {_mib(params):.2f} MiB, moments "
          f"{_mib((opt.mu, opt.nu)):.2f} MiB", flush=True)
    step_fn = make_train_step(cfg, tcfg, mesh)
    got = []
    for s in range(args.steps):
        batch = {k: torch.from_numpy(v).to(mesh.device)
                 for k, v in with_frames(source.batch(s), cfg, args.seed, s).items()}
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, s)
        got.append((float(m["loss"]), float(m["grad_norm"])))  # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        if mesh.rank == 0:
            print(f"step {s}: loss {got[-1][0]:.6f}  grad norm {got[-1][1]:.6f}  {ms:.1f} ms",
                  flush=True)
    rc = 0
    if args.check and mesh.rank == 0:
        p1, o1 = init_train_state(cfg, args.seed, mesh.device)
        one = make_train_step(cfg, tcfg)
        worst = 0.0
        for s in range(args.steps):
            batch = {k: torch.from_numpy(v).to(mesh.device)
                 for k, v in with_frames(source.batch(s), cfg, args.seed, s).items()}
            p1, o1, m = one(p1, o1, batch, s)
            for a, b in zip(got[s], (float(m["loss"]), float(m["grad_norm"]))):
                worst = max(worst, abs(a - b) / abs(b))
        same = worst <= CHECK_RTOL
        print(f"losses and grad norms {'match' if same else 'differ from'} the single-device "
              f"step's (largest relative difference {worst:.3g}, limit {CHECK_RTOL})", flush=True)
        rc = 0 if same else 1
    dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
