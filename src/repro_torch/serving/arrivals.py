"""Seeded arrival-trace generators for the serving launcher.

The port of the JAX package's ``repro.serving.arrivals``.  Every trace is a
list of ``Arrival`` records (arrival time in seconds from the trace's start,
tenant id and fair-queue weight, prompt length) drawn from a seeded numpy
generator, so a trace is a pure function of its knobs.

* ``poisson_times`` — a homogeneous Poisson process at ``rate`` requests a
  second (i.i.d. exponential gaps);
* ``bursty_times`` — a square wave: the rate alternates between
  ``base_rate`` and ``burst_rate`` every half ``period_s``, drawn by
  thinning (propose at the larger rate, accept with probability
  ``rate(t) / max_rate``), an exact non-homogeneous Poisson process.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request arrival in a trace."""

    t: float  # seconds from the trace's start
    prompt_len: int
    tenant: str = "default"
    weight: float = 1.0


def poisson_times(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """Arrival times of ``n`` events of a Poisson process at ``rate``/s."""
    if rate <= 0.0:
        raise ValueError(f"rate must be > 0, got {rate}")
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_times(base_rate: float, burst_rate: float, period_s: float, n: int,
                 rng: np.random.Generator) -> np.ndarray:
    """Arrival times of ``n`` events of a square-wave-rate Poisson process:
    ``base_rate`` in the first half of every ``period_s`` window,
    ``burst_rate`` in the second."""
    if min(base_rate, burst_rate) <= 0.0 or period_s <= 0.0:
        raise ValueError("rates and period_s must be > 0")
    rmax = max(base_rate, burst_rate)
    times = np.empty(n)
    t, i = 0.0, 0
    while i < n:
        t += float(rng.exponential(1.0 / rmax))
        r = burst_rate if (t % period_s) >= period_s / 2.0 else base_rate
        if rng.random() <= r / rmax:
            times[i] = t
            i += 1
    return times


def make_trace(
    n: int,
    *,
    kind: str = "poisson",  # "poisson" | "bursty"
    rate: float = 10.0,
    burst_rate: Optional[float] = None,  # bursty: the high phase's rate (default 4x)
    period_s: float = 2.0,  # bursty: the square wave's period
    seed: int = 0,
    prompt_lens: Tuple[int, int] = (8, 32),  # uniform [lo, hi] a request
    tenants: Sequence[Tuple[str, float, float]] = (("default", 1.0, 1.0),),
    # (tenant id, fair-queue weight, traffic share); shares are normalized
) -> List[Arrival]:
    """One seeded multi-tenant trace: arrival process x prompt mix x tenants."""
    if kind not in ("poisson", "bursty"):
        raise ValueError(f"unknown trace kind {kind!r}")
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        times = poisson_times(rate, n, rng)
    else:
        times = bursty_times(rate, burst_rate or 4.0 * rate, period_s, n, rng)
    lo, hi = prompt_lens
    if not 1 <= lo <= hi:
        raise ValueError(f"prompt_lens must satisfy 1 <= lo <= hi, got {prompt_lens}")
    lens = rng.integers(lo, hi + 1, size=n)
    shares = np.asarray([s for _, _, s in tenants], np.float64)
    shares = shares / shares.sum()
    picks = rng.choice(len(tenants), size=n, p=shares)
    return [Arrival(t=float(times[i]), prompt_len=int(lens[i]), tenant=tenants[picks[i]][0],
                    weight=float(tenants[picks[i]][1]))
            for i in range(n)]
