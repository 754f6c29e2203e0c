"""Device resolution shared by every entry point of the port.

Entry points (`Scheduler`, `ServeEngine`, `transformer.init`,
`convert.params_from_numpy`) default to ``device="cuda"`` and run on the
CPU only when the caller asks for it, as the CPU tests do.  There is no
silent fallback: without a GPU, a CUDA request raises.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``, raising if it is CUDA and no GPU is
    present.  Also pins float32 numerics: TF32 is off for matmuls and
    cuDNN, so a float32 product on the card keeps full float32 precision
    (cuDNN otherwise defaults to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device`.  On CUDA it is staged in pinned memory and
    copied without blocking the host: a pageable copy would wait for all
    the work queued on the stream (a decode chunk in flight).  The caching
    host allocator keeps the staging block until its copy has run."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
