"""Where xLSTM's bf16 logits on a (data 2, model 2) mesh part from one
device's, and which product starts it.

Four gloo ranks (processes on one device) serve xlstm-1.3b at full width,
cut to one group of 8 layers, with bf16 ``init_like_jax`` weights: 4
prompts of 256 tokens prefilled, then greedy decode steps fed one device's
tokens, through ``examples.serve_mesh.serve_family``.  Rank 0 also runs
the same cut model on one device, plainly and with ``w_out`` taken in the
mesh's order (two f32 half products summed, ``_mesh_order``).  It prints
each run's logits against the plain one device's (the largest |difference|
of a step over that step's largest |logit|), each block's output against
it at the prefill (that reading, and the share of elements that differ),
and block 0's products one by one (q, k, v, the input and forget gates,
the output gate, the ``hnorm`` output and the block's output).

    PYTHONPATH=src python -m repro_torch.examples.xlstm_mesh_gap [--device cpu]
        [--d-model 512] [--prompt-len 128]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile

import numpy as np
import torch

NAMES = ("mlstm_prefill", "slstm_forward", "mlstm_decode", "slstm_decode")
FIRST = ("_mlstm_project", "_head_norm", "_mlstm_finish")
PROJECTED = ("q", "k", "v", "input gate", "forget gate", "output gate")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _apart(got: np.ndarray, want: np.ndarray) -> tuple:
    """(largest |difference| over largest |want|, share of elements apart)."""
    return (float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)),
            float((got != want).mean()))


@contextlib.contextmanager
def _patched(module, **fns):
    real = {n: getattr(module, n) for n in fns}
    for n, f in fns.items():
        setattr(module, n, f)
    try:
        yield
    finally:
        for n, f in real.items():
            setattr(module, n, f)


def _mesh_order(X):
    """One device's ``w_out`` products in the serving mesh's order."""
    real_out, real_whole = X._row_out, X._row_out_whole

    def halves(y, w):
        k = y.shape[-1] // 2
        return (y[..., :k].float() @ w[:k].float() + y[..., k:].float() @ w[k:].float()).to(y.dtype)

    return _patched(
        X, _row_out=lambda y, w, pctx, shape: (halves(y, w) if pctx.mesh is None
                                               else real_out(y, w, pctx, shape)),
        _row_out_whole=lambda y, w, pctx: (halves(y, w) if pctx.mesh is None
                                           else real_whole(y, w, pctx)))


def _roll(cfg, params, mesh, prompts, steps, feed=None, order=False):
    """(greedy tokens, each step's logits, each block's output, block 0's
    products) of the cut model served on ``mesh`` (None: one device)."""
    from repro_torch.core.phase_engine import PhaseEngine
    from repro_torch.examples.serve_mesh import serve_family
    from repro_torch.models import xlstm as X

    blocks, first = [], {}
    real = {n: getattr(X, n) for n in NAMES + FIRST}

    def block(name):
        def run(*a, **k):
            out = real[name](*a, **k)
            blocks.append((name, _np(out[0])))
            return out
        return run

    def product(name):
        def run(*a, **k):
            out = real[name](*a, **k)
            if name not in first:
                first[name] = ([_np(t) for t in out] if name == "_mlstm_project"
                               else [_np(out)])
            return out
        return run

    logits = []
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(X, **{n: block(n) for n in NAMES},
                                     **{n: product(n) for n in FIRST}))
        if order:
            stack.enter_context(_mesh_order(X))
        toks, _ = serve_family(PhaseEngine(cfg, mesh), params, prompts, steps, 8,
                               on_step=lambda i, lg: logits.append(_np(lg)), feed=feed)
    return toks, logits, blocks, first


def _whole(cfg, every, name, j, want):
    """Block 0's product ``j`` of ``name`` put together from the ranks'
    parts: rank 2r + m holds batch rows [2r, 2r + 2) and heads (or their
    channels) [m H / 2, (m + 1) H / 2)."""
    got = np.zeros_like(want)
    for rank, (_, first) in enumerate(every):
        r, m = divmod(rank, 2)
        part, rows = first[name][j], slice(2 * r, 2 * r + 2)
        if part.shape == want[rows].shape:
            got[rows] = part
        elif part.ndim in (3, 4) and 2 * part.shape[1] == want.shape[1] == cfg.num_heads:
            got[rows, 2 * m:2 * m + 2] = part
        else:
            c = want.shape[-1] // 2
            got[rows, ..., m * c:(m + 1) * c] = part
    return got


def rank_main(rank: int, world: int, store: str, args) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import join_process_group, make_mesh
    from repro_torch.launch.sharding_rules import shard_params
    from repro_torch.models.jax_init import init_like_jax

    torch.set_num_threads(2)
    join_process_group("gloo", device_type=args.device, init_method=f"file://{store}",
                       rank=rank, world_size=world, timeout_s=900)
    mesh = make_mesh((2, 2), ("data", "model"))
    cut = dict(num_layers=8)
    if args.d_model != 2048:
        cut.update(d_model=args.d_model, vocab_size=4096)
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), **cut)
    whole = init_like_jax(cfg, 0, mesh.device, draw_device=mesh.device, dtype=torch.bfloat16)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, args.prompt_len)).astype(np.int32)
    box = [None]
    if rank == 0:
        plain = _roll(cfg, whole, None, prompts, args.steps)
        box = [(plain, _roll(cfg, whole, None, prompts, args.steps, feed=plain[0][:-1],
                             order=True))]
    dist.broadcast_object_list(box, src=0)
    plain, ordered = box[0]
    got = _roll(cfg, shard_params(whole, cfg, mesh), mesh, prompts, args.steps,
                feed=plain[0][:-1])
    every = [None] * world
    dist.all_gather_object(every, (got[2], got[3]))
    if rank == 0:
        def logits(a, b):
            return max(_apart(x, y)[0] for x, y in zip(a, b))

        print(f"xlstm-1.3b d_model {cfg.d_model}, 8 layers, 4 x {args.prompt_len} tokens, bf16 "
              f"weights, {args.steps - 1} decode steps on {args.device}; logits over max "
              f"|logit|: the mesh against one device {logits(got[1], plain[1]):.4g}; one "
              f"device in the mesh's w_out order against it {logits(ordered[1], plain[1]):.4g}; the mesh against "
              f"that {logits(got[1], ordered[1]):.4g}")
        for tag, rows in (("the mesh", [np.concatenate([every[0][0][i][1], every[2][0][i][1]])
                                        for i in range(len(plain[2]))]),
                          ("one device in the mesh's w_out order",
                           [b for _, b in ordered[2]])):
            apart = [f"{i} {name} {_apart(g, w)[0]:.3g} ({_apart(g, w)[1]:.3g})"
                     for i, ((name, w), g) in enumerate(zip(plain[2], rows))][:cfg.num_layers + 2]
            print(f"each block's output, {tag} against one device (reading, share apart): "
                  + "; ".join(apart))
        parts = []
        for name in FIRST:
            for j, want in enumerate(plain[3][name]):
                what = PROJECTED[j] if name == "_mlstm_project" else (
                    "hnorm" if name == "_head_norm" else "block output")
                g = _whole(cfg, every, name, j, want)
                parts.append(f"{what} {_apart(g, want)[0]:.3g} ({_apart(g, want)[1]:.3g})")
        print("block 0's products, the mesh against one device (reading, share apart): "
              + "; ".join(parts))
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=17)
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp

    store = os.path.join(tempfile.mkdtemp(), "store")
    mp.spawn(rank_main, args=(4, store, args), nprocs=4)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
