"""Device resolution for the port's entry points.

Entry points default to ``"cuda"`` and raise when no card is present: a
caller who wants the CPU (the plain PyTorch versions of the kernels) asks
for it with ``device="cpu"``. There is no silent fallback.

The port keeps torch's default TF32 settings and flips no process-wide
flag: on the card a ``precision: "float32"`` run convolves in TF32 unless
the caller sets ``torch.backends.cudnn.allow_tf32 = False`` (as
``chip_smoke.py`` and the CUDA tests do). This mirrors JAX, whose default
precision also lets float32 products and convolutions run in TF32 on
NVIDIA cards. bfloat16 runs are not affected.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for but absent."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions")
        return device
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device
