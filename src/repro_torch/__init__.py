"""PD-Swap on PyTorch and CUDA: the port of the JAX package ``repro``.

The serving path of ``bitnet-730m`` — packed ternary linears through the
TLMM kernel, the reverse-scheduled prefill attention kernel, the decode
attention kernel, the overlapped KV relayout and the step-driven engine —
with every TPU kernel rewritten by hand in CUDA C++ for Hopper
(``csrc/*.cu``).  On CPU tensors each kernel wrapper runs its plain PyTorch
version instead; that is what the tests use.

Float32 stays float32: TF32 is switched off for matmuls and cuDNN, since the
embedding and logits products are plain ``torch.matmul`` calls held against
the JAX package's full-precision f32 products.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or defaulted to) and absent —
    a serving entry point never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
