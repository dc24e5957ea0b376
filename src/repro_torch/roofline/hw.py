"""Target-hardware model of the port (one NVIDIA H100 SXM5 80 GB) for the
roofline and the timing engine.

``HW_H100`` holds the data sheet's dense rates at the card's 700 W
limit: 989e12 FLOP/s bf16 on the tensor cores, 67e12 FLOP/s f32 outside
them, 3.35e12 B/s of HBM3, 80e9 B of it and 228 KiB of shared memory an
SM. The link fields name NVLink (18 links of 25e9 B/s a direction);
they feed only ``InterfaceTimer.collective``, which one card never
calls. A card set below 700 W runs slower under load: a share of these
peaks is read beside the card's name and power limit.

The exponential rate K3's bound rests on is not a data-sheet figure: it
is the special-function units' throughput (``exp_rate``).
"""
from __future__ import annotations

import dataclasses
import subprocess

import torch

# exponentials (MUFU.EX2) a clock per SM on compute capability 9.0: the
# arithmetic-instruction throughput table of the CUDA C++ Programming
# Guide
SFU_PER_CLOCK_PER_SM = 16


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops_bf16: float       # per card, FLOP/s
    hbm_bw: float                # per card, B/s
    ici_link_bw: float           # per link per direction, B/s (NVLink)
    ici_links: int               # links per card
    hbm_bytes: float             # capacity per card
    vmem_bytes: float            # on-chip scratch per core (SM shared mem)
    peak_flops_f32: float = 0.0  # per card, FLOP/s outside the tensor cores

    def flops_rate(self, dtype) -> float:
        """The peak FLOP/s for products in ``dtype``: the tensor cores'
        for bf16 and fp16, the f32 pipes' for anything else."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.peak_flops_bf16
        return self.peak_flops_f32 or self.peak_flops_bf16


HW_H100 = Hardware(
    name="h100_sxm5_80gb",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_link_bw=25e9,
    ici_links=18,
    hbm_bytes=80e9,
    vmem_bytes=228 * 2**10,
    peak_flops_f32=67e12,
)


def exp_rate(sms: int, max_sm_clock_hz: float) -> float:
    """Exponentials a second: ``SFU_PER_CLOCK_PER_SM`` (16 a clock per
    SM on compute capability 9.0, the CUDA C++ Programming Guide's
    arithmetic-instruction throughput table) times the SMs times the
    maximum SM clock."""
    return SFU_PER_CLOCK_PER_SM * sms * max_sm_clock_hz


def device_exp_rate(device=None) -> float:
    """``exp_rate`` of the card ``device`` names: its SM count from its
    properties and its maximum SM clock as ``nvidia-smi --query-gpu=
    clocks.max.sm`` reports it."""
    index = torch.device(device or "cuda").index
    if index is None:
        index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    mhz = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return exp_rate(sms, float(mhz) * 1e6)


def bound(cost: dict, dtype=torch.bfloat16, hw: Hardware = HW_H100,
          exps_per_s: float = 0.0) -> dict:
    """The least time the card could take for ``cost`` (``flops``,
    ``bytes`` and optionally ``exps``, as a kernel's ``cost`` or
    ``roofline.cost.count_cost`` gives them): the larger of the bytes
    over the memory rate and the operations over their peak rates (the
    products in ``dtype``, the exponentials at ``exps_per_s``). Returns
    the seconds of each term, the bound and what sets it ("bytes" or
    "operations")."""
    bytes_s = cost["bytes"] / hw.hbm_bw
    flops_s = cost["flops"] / hw.flops_rate(dtype)
    exps = cost.get("exps", 0)
    if exps and not exps_per_s:
        raise ValueError("an exponential count needs exps_per_s "
                         "(device_exp_rate)")
    exps_s = exps / exps_per_s if exps else 0.0
    ops_s = max(flops_s, exps_s)
    return {"bound_s": max(bytes_s, ops_s),
            "bound_by": "bytes" if bytes_s >= ops_s else "operations",
            "bytes_s": bytes_s, "flops_s": flops_s, "exps_s": exps_s}
