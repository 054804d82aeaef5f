"""Training entry point with the fault-tolerance loop: the port of the JAX
package's ``repro.launch.train``, with its arguments and printout.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 500 --ckpt-dir ckpt [--reduced --device cpu]

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

``--mesh`` takes only ``none``: the JAX launcher's meshes (host, single,
multi) are mesh tooling (ROADMAP A.10).  ``train(args)`` is the loop,
returning the final state and each step's metrics; ``main`` prints as the
JAX launcher does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ALL_ARCHS, ModelConfig, get_config, reduced_config
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.optim.adamw import AdamWState
from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step


@dataclasses.dataclass
class TrainResult:
    cfg: ModelConfig
    tcfg: TrainConfig
    params: dict
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
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--restore", action="store_true")
    p.add_argument("--max-retries", type=int, default=2)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model trains (the card unless cpu is asked for)")
    return p.parse_args(argv)


def train(args: argparse.Namespace) -> TrainResult:
    if args.mesh != "none":
        raise NotImplementedError(f"--mesh {args.mesh}: the port trains on one device; the JAX "
                                  "launcher's meshes are mesh tooling (ROADMAP A.10)")
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainConfig(lr=args.lr, schedule=args.schedule, warmup=max(args.steps // 20, 5),
                       total_steps=args.steps, microbatches=args.microbatches)
    dcfg = DataConfig(batch=args.batch, seq_len=args.seq, vocab_size=cfg.vocab_size, seed=args.seed)
    source = make_source(dcfg)

    params, opt = init_train_state(cfg, args.seed, dev)
    step_fn = make_train_step(cfg, tcfg)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and args.restore and mgr.latest_step() is not None:
        (params, opt), start = mgr.restore((params, opt))
        print(f"[restore] resumed from step {start} (mesh={args.mesh})")

    def checkpoint(step, blocking=False):
        if not mgr:
            return
        mgr.save_async(step, (params, opt))
        if blocking:
            mgr.wait()

    history, events = {}, {}
    metrics = None
    step = start
    retries = 0
    t0 = time.time()
    while step < args.steps:
        try:
            batch = {k: torch.from_numpy(v).to(dev) for k, v in source.batch(step).items()}
            if dev.type == "cuda":
                events[step] = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                events[step][0].record()
            params, opt, metrics = step_fn(params, opt, batch, step)
            if dev.type == "cuda":
                events[step][1].record()
            history[step] = metrics
            if step % args.log_every == 0:
                loss = float(metrics["loss"])
                tput = dcfg.batch * dcfg.seq_len * max(step - start, 1) / (time.time() - t0)
                print(f"step {step:5d}  loss {loss:.4f}  lr {float(metrics['lr']):.2e}  "
                      f"{tput:,.0f} tok/s")
            step += 1
            if mgr and step % args.ckpt_every == 0:
                checkpoint(step)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # transient failure -> restore & replay
            retries += 1
            print(f"[fault] step {step} failed ({e!r}); retry {retries}/{args.max_retries}")
            if retries > args.max_retries or mgr is None:
                raise
            mgr.wait()
            (params, opt), step = mgr.restore((params, opt))
            print(f"[fault] restored step {step}, replaying")

    if mgr:
        checkpoint(step, blocking=True)
        print(f"[done] final checkpoint at step {step} -> {mgr.dir}")
    final_loss = float(metrics["loss"]) if step > start else float("nan")
    print(f"[done] {step - start} steps in {time.time() - t0:.1f}s, final loss {final_loss:.4f}")
    history = {s: {k: float(v) for k, v in m.items()} for s, m in sorted(history.items())}
    for s, (e0, e1) in events.items():
        history[s]["ms"] = e0.elapsed_time(e1)
    return TrainResult(cfg, tcfg, params, opt, start, step, history)


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
