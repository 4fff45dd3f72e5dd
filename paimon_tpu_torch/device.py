"""Device selection for the port's entry points.

Every entry point takes an explicit `device`; None means "cuda".  A
caller that wants the CPU asks for it: the port never moves to the CPU
on its own when no card is present.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """torch.device for `device` (None -> cuda); raises RuntimeError when
    a CUDA device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paimon_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
