"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives.  NVIDIA's H100 SXM data sheet,
dense rates without sparsity, at the 700 W power limit.  A card missing
here has no peaks, and every share of a peak or a roofline reads nothing
on it."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_s": 3.35e12,
    },
}


def peaks_of(kind: str) -> Optional[dict]:
    return PEAKS.get(kind)
