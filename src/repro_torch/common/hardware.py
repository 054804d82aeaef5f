"""Hardware constants of the port's card (NVIDIA H100 SXM) and of the JAX
package's target (TPU v5e), for the analytic rooflines in
``core.roofline`` and the drift metric in ``obs.drift``.

``TPU_V5E`` is the JAX package's chip, kept so that both packages can be
handed the same chip and held to each other; the port's ``DEFAULT_CHIP`` is
``H100_SXM``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-chip hardware constants (the JAX package's fields)."""

    name: str
    # peak compute (operations a second), dense
    peak_flops_bf16: float
    peak_flops_int8: float
    # device memory
    hbm_bytes: int
    hbm_bw: float  # bytes/s
    # chip-to-chip interconnect, per link
    ici_bw_per_link: float  # bytes/s, one direction
    ici_links: int
    # on-chip memory a working set can stay in (the paper's LUT/URAM budget)
    vmem_bytes: int
    # host <-> device
    dcn_bw: float  # bytes/s, one direction


TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    peak_flops_int8=394e12,
    hbm_bytes=16 * 1024**3,
    hbm_bw=819e9,
    ici_bw_per_link=50e9,
    ici_links=4,
    vmem_bytes=128 * 1024**2,
    dcn_bw=25e9,
)

# NVIDIA H100 Tensor Core GPU datasheet, the SXM5 part, dense (no sparsity)
# figures at the 700 W limit.
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,  # BF16 Tensor Core, dense
    peak_flops_int8=1979e12,  # INT8 Tensor Core, dense
    hbm_bytes=80 * 1024**3,  # 80 GB HBM3
    hbm_bw=3.35e12,  # HBM3, 3.35 TB/s
    # NVLink 4: 900 GB/s both directions over 18 links, i.e. 25 GB/s a link
    # each way
    ici_bw_per_link=25e9,
    ici_links=18,
    # The 50 MB L2: the largest on-chip store a kernel's working set can be
    # held in across launches (shared memory is 228 KB an SM and lives only
    # as long as a block), so it plays the part of the TPU's VMEM.
    vmem_bytes=50 * 1024**2,
    dcn_bw=64e9,  # PCIe Gen5 x16: 128 GB/s both directions, 64 GB/s each way
)

DEFAULT_CHIP = H100_SXM
