"""Hand-written CUDA kernels of the port and their launch counters.

``COUNTS[name]`` is a plain integer that a kernel's wrapper raises by one
where it launches the kernel, and nowhere else: a run that set the counts to
0 first shows afterwards which kernels its path went through.  Wrappers
given CPU tensors run the plain PyTorch version and leave the count alone.
"""
from __future__ import annotations

from typing import Dict

COUNTS: Dict[str, int] = {
    "act_quant": 0, "tlmm": 0, "prefill_attention": 0, "decode_attention": 0,
    "decode_attention_quant": 0, "paged_decode_attention": 0, "paged_decode_attention_quant": 0,
}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
