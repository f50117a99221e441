"""Device choice for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. A CUDA
device without a usable card raises: there is no silent move to the CPU.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
