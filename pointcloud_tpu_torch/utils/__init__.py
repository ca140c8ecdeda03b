"""Utilities: the program's spans and counters and the device trace
(`profiling`), and the device check of the entry points."""

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA device on a machine without a card
    raises (pass device='cpu' to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} needs a CUDA device; pass "
                           "device='cpu' to run on the CPU")
    return device
