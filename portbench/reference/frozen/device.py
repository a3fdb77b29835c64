"""Device selection for the port's entry points.

Entry points take an explicit ``device`` and default to the card. Asking
for the card where there is none raises: nothing moves quietly to the CPU.
The CPU runs the plain PyTorch versions of the kernels, and only when the
caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
