"""Device tensors written in place from host values.

A CUDA graph reads its inputs from fixed addresses, so the engine keeps
what changes between rounds (slot lengths, block tables, the tokens of a
replayed step, a chunk's tokens, pages and scalars) in static device
tensors and writes them in place.  On a card the values go through a
pinned staging buffer with a non-blocking copy; an event recorded after the
copy fences the buffer, so the next upload waits for the previous copy to
have run before it overwrites the staged values, and never for the rest of
the stream.  On the CPU the copy is a plain one.
"""
from __future__ import annotations

import numpy as np
import torch


class StagedTensor:
    """``dev``: a static device tensor of ``shape`` and ``dtype``;
    ``upload(values)`` writes host values into it in place."""

    def __init__(self, shape, dtype: torch.dtype, device):
        device = torch.device(device)
        self.cuda = device.type == "cuda"
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        self._host = torch.zeros(shape, dtype=dtype, pin_memory=self.cuda)
        self._copied = torch.cuda.Event() if self.cuda else None

    def upload(self, values) -> torch.Tensor:
        """Write ``values`` (anything numpy broadcasts to the shape) into
        ``dev`` and return it."""
        if self.cuda:
            self._copied.synchronize()  # the previous copy out of the staging buffer has run
        self._host.numpy()[...] = np.asarray(values)
        self.dev.copy_(self._host, non_blocking=self.cuda)
        if self.cuda:
            self._copied.record()
        return self.dev
