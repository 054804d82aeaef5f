"""Learning-rate schedules, warmup-cosine and WSD (warmup-stable-decay,
MiniCPM): the port of ``repro.optim.schedules``, in f32 as the JAX ones
compute them (``log(final_frac)`` included)."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int, final_frac: float = 0.1):
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def wsd(step, *, peak_lr: float, warmup: int, total: int, decay_frac: float = 0.1,
        final_frac: float = 0.01):
    """MiniCPM's warmup-stable-decay: flat plateau, late exponential decay."""
    step = _f32(step)
    decay_start = total * (1 - decay_frac)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
    dec = peak_lr * torch.exp(torch.log(_f32(final_frac)) * prog)
    out = torch.where(step < warmup, warm, _f32(peak_lr))
    return torch.where(step > decay_start, dec, out)


SCHEDULES = {"cosine": warmup_cosine, "wsd": wsd}
