"""The run's device, shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The run's device.  CUDA must be present when asked for (no silent
    CPU run), and fp32 convolutions and matmuls then run without TF32."""
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'device {device!r} requested but CUDA is '
                               f'not available; pass device="cpu" to run '
                               f'on the CPU')
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
