"""The optimizer, the learning-rate schedules and the error-feedback
compressed gradient mean over a mesh axis (the port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm
from repro_torch.optim.compression import (
    compressed_dp_grads,
    compressed_mean_over_axis,
    init_error_feedback,
)
from repro_torch.optim.schedules import SCHEDULES, warmup_cosine, wsd

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm",
           "compressed_dp_grads", "compressed_mean_over_axis", "init_error_feedback",
           "SCHEDULES", "warmup_cosine", "wsd"]
