"""Device resolution shared by every entry point of the port.

The counterpart of ``kaarme_tpu/utils/platform.py``: every entry point
takes its device explicitly, and asking for a CUDA device on a machine
without one raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> torch.device.

    Raises RuntimeError when a CUDA device is asked for and none is
    available, and ValueError for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False (pass device='cpu' to run the plain CPU path)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(device)!r} (use 'cuda' or 'cpu')")
