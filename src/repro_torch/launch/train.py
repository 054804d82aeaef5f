"""Training entry point with the fault-tolerance loop: the port of the JAX
package's ``repro.launch.train``, with its arguments and printout.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 500 --ckpt-dir ckpt [--reduced --device cpu]
    # on a mesh of processes, one rank a process:
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --mesh host --backend gloo ...

It runs on the card unless ``--device cpu`` is given.  The weights are the
JAX launcher's (``init_like_jax``: the same seed draws the same weights to
float rounding), the batches its byte for byte, the checkpoints in its
format, so a run of either package resumes in the other.

Fault tolerance, as in the JAX launcher:
  * a checkpoint every ``--ckpt-every`` steps (the host copy synchronous,
    the write on a background thread) and a final one;
  * crash-safe checkpoints (a tmp directory, then an atomic rename);
  * ``--restore`` resumes from the latest complete checkpoint;
  * the data is a pure function of (seed, step), so a restart at step N
    replays the same stream;
  * a step that raises restores the last checkpoint and replays from
    there, up to ``--max-retries`` times.

``--mesh host|single|multi`` trains on the JAX launcher's meshes: ``host``
is ``make_host_mesh`` over the world the launcher started, (data N, model
1) for N ranks (FSDP alone; other shapes are ``examples/train_mesh.py``'s
``--data`` and ``--model``), ``single`` and ``multi`` the production
(data 16, model 16) and (pod 2, data 16, model 16), which raise unless
the world has that many ranks.  Start the ranks with
``torch.distributed.run`` and name the backend (``--backend nccl|gloo``);
with no launcher the world is this one process.  Every rank holds its
FSDP x TP slice.  On a mesh every rank learns, after each step and each
checkpoint, whether it raised on any rank (a flag summed over the host
group), and then every rank restores and replays together.  A fault
inside a step's collectives on some ranks only cannot be replayed: the
others wait in that collective, the world stops at the process group's
timeout, and a restart with ``--restore`` resumes.  A checkpoint is the
whole tree, gathered and written by rank 0 in the single-process format;
``--restore`` reads it on every rank and keeps each rank's slice for the
mesh it runs on now, whatever mesh saved it (JAX's elastic restore).
Every family trains on a mesh (hymba, xLSTM and whisper under the same
FSDP x TP rules); an encoder-decoder's batches carry the stub's frames
(``data.pipeline.with_frames``).  Rank 0 prints.  ``train(args)`` is the loop, returning the final state
and each step's metrics; ``main`` prints as the JAX launcher does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ALL_ARCHS, ModelConfig, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, make_source, with_frames
from repro_torch.launch.mesh import BACKENDS, join_process_group, make_host_mesh, make_production_mesh
from repro_torch.launch.sharding_rules import gather_params, leaf_specs
from repro_torch.layers.sharding import P
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step


@dataclasses.dataclass
class TrainResult:
    cfg: ModelConfig
    tcfg: TrainConfig
    params: dict  # on a mesh, this rank's slice
    opt: AdamWState
    start: int  # the step the run started from (0, or the restored one)
    step: int  # the step it ended at
    history: Dict[int, Dict[str, float]]  # each step's metrics; on a card also "ms" (CUDA events)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", choices=ALL_ARCHS, default="smollm-135m")
    p.add_argument("--reduced", action="store_true", help="reduced same-family config (CPU)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--schedule", default="cosine", choices=["cosine", "wsd"])
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--mesh", default="none", choices=["none", "host", "single", "multi"])
    p.add_argument("--backend", choices=BACKENDS, default=None,
                   help="the collectives' backend; required with --mesh")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--restore", action="store_true")
    p.add_argument("--max-retries", type=int, default=2)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model trains (the card unless cpu is asked for)")
    return p.parse_args(argv)


def build_mesh(args: argparse.Namespace):
    """The mesh ``--mesh`` names, on the world the launcher started (or a
    world of this one process); None for ``none``.  ``host`` is (data N,
    model 1) on a world of N."""
    if args.mesh == "none":
        return None
    if args.mesh == "host":
        return make_host_mesh(data=dist.get_world_size())
    return make_production_mesh(multi_pod=args.mesh == "multi")


def state_specs(params, cfg: ModelConfig, mesh) -> dict:
    """Each (params, AdamWState) leaf's name -> its spec: the moments take
    their parameter's, the step count is replicated."""
    specs = leaf_specs(params, cfg, mesh, train=True)
    out = {f"0/{n}": s for n, s in specs.items()}
    for m in ("mu", "nu"):
        out.update({f"1/{m}/{n}": s for n, s in specs.items()})
    out["1/step"] = P()
    return out


def gather_state(params, opt: AdamWState, cfg: ModelConfig, mesh, only: Optional[int] = None):
    """The whole (params, AdamWState) on the host: on every rank, or (with
    ``only``) on that rank alone, the others getting None leaves."""
    def whole(t):
        return gather_params(t, cfg, mesh, train=True, device="cpu", only=only)

    return whole(params), AdamWState(opt.step.cpu(), whole(opt.mu), whole(opt.nu))


def train(args: argparse.Namespace) -> TrainResult:
    if args.mesh == "none":
        return _train(args, None)
    if args.backend is None:
        raise ValueError(f"--mesh {args.mesh} needs --backend nccl or gloo")
    own, store = not dist.is_initialized(), None
    if own:
        if "RANK" in os.environ:  # started by torch.distributed.run
            join_process_group(args.backend, device_type=args.device)
        else:  # a world of this one process
            store = tempfile.TemporaryDirectory()
            join_process_group(args.backend, device_type=args.device, rank=0, world_size=1,
                               init_method=f"file://{os.path.join(store.name, 'store')}")
    try:
        return _train(args, build_mesh(args))
    finally:
        if own:
            dist.destroy_process_group()
            if store is not None:
                store.cleanup()


def _train(args: argparse.Namespace, mesh) -> TrainResult:
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0  # the rank that prints and writes
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainConfig(lr=args.lr, schedule=args.schedule, warmup=max(args.steps // 20, 5),
                       total_steps=args.steps, microbatches=args.microbatches)
    dcfg = DataConfig(batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size, seed=args.seed)
    source = make_source(dcfg)

    params, opt = init_train_state(cfg, args.seed, dev, mesh=mesh)
    step_fn = make_train_step(cfg, tcfg, mesh)
    specs = state_specs(params, cfg, mesh) if mesh is not None else None

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    def restore():
        (p, o), at = mgr.restore((params, opt), device=dev, shardings=specs, mesh=mesh)
        return p, o, at

    start = 0
    if mgr and args.restore and mgr.latest_step() is not None:
        params, opt, start = restore()
        if lead:
            print(f"[restore] resumed from step {start} (mesh={args.mesh})")

    def checkpoint(step, blocking=False):
        if not mgr:
            return
        tree = (params, opt) if mesh is None else gather_state(params, opt, cfg, mesh, only=0)
        if lead:
            mgr.save_async(step, tree)
            if blocking:
                mgr.wait()

    history, events = {}, {}
    metrics = None
    step = start
    retries = 0
    t0 = time.time()

    def run_step():
        nonlocal params, opt, metrics
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in with_frames(source.batch(step), cfg, args.seed, step).items()}
        if dev.type == "cuda":
            events[step] = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            events[step][0].record()
        params, opt, metrics = step_fn(params, opt, batch, step)
        if dev.type == "cuda":
            events[step][1].record()
        history[step] = metrics
        if step % args.log_every == 0 and lead:
            loss = float(metrics["loss"])
            tput = dcfg.batch * dcfg.seq_len * max(step - start, 1) / (time.time() - t0)
            print(f"step {step:5d}  loss {loss:.4f}  lr {float(metrics['lr']):.2e}  "
                  f"{tput:,.0f} tok/s")

    while step < args.steps:
        fault = _attempt(run_step, mesh)
        if fault is None:
            step += 1
            if mgr and step % args.ckpt_every == 0:
                fault = _attempt(lambda: checkpoint(step), mesh)
        if fault is None:
            continue
        # transient failure -> restore & replay
        retries += 1
        if lead:
            print(f"[fault] step {step} failed ({fault!r}); retry {retries}/{args.max_retries}")
        if retries > args.max_retries or mgr is None:
            raise fault
        if lead:
            mgr.wait()
        if mesh is not None:  # rank 0's write is whole before any rank reads it
            dist.barrier(group=mesh.host_group)
        params, opt, step = restore()
        if lead:
            print(f"[fault] restored step {step}, replaying")

    if mgr:
        checkpoint(step, blocking=True)
        if lead:
            print(f"[done] final checkpoint at step {step} -> {mgr.dir}")
    final_loss = float(metrics["loss"]) if step > start else float("nan")
    if lead:
        print(f"[done] {step - start} steps in {time.time() - t0:.1f}s, final loss {final_loss:.4f}")
    history = {s: {k: float(v) for k, v in m.items()} for s, m in sorted(history.items())}
    for s, (e0, e1) in events.items():
        history[s]["ms"] = e0.elapsed_time(e1)
    return TrainResult(cfg, tcfg, params, opt, start, step, history)


def _attempt(fn, mesh) -> Optional[Exception]:
    """Run ``fn``: None if it returned on every rank, else the exception it
    raised here, or (on a rank where it returned) one naming the ranks
    where it raised.  On a mesh every rank sums a flag over the host group
    after ``fn``, so all of them take the same branch; a rank that raised
    must have left no collective of ``fn`` for the others to wait in."""
    try:
        fn()
        err = None
    except KeyboardInterrupt:
        raise
    except Exception as e:  # noqa: BLE001 — the loop restores and replays
        err = e
    if mesh is None:
        return err
    flags = torch.zeros(mesh.size, dtype=torch.int32)
    flags[mesh.rank] = err is not None
    dist.all_reduce(flags, group=mesh.host_group)
    if err is None and flags.any():
        err = RuntimeError(f"raised on rank(s) {flags.nonzero().flatten().tolist()}")
    return err


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
