"""The optimizer and the learning-rate schedules (the port of ``repro.optim``).

The JAX package's ``optim/compression.py`` (error-feedback compressed mean
over a pod axis, a ``shard_map`` collective) is mesh tooling: it goes with
the two-card and mesh items of ROADMAP A.8 / A.10.
"""
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedules import SCHEDULES, warmup_cosine, wsd

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm",
           "SCHEDULES", "warmup_cosine", "wsd"]
