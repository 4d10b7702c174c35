"""PyTorch/CUDA port of ``pytorch_distributed_training_tpu``, for an H100.

The JAX package beside this one is the reference; this package mirrors its
layout and names, imports torch (never JAX, nor anything of the JAX
package), and replaces each Pallas TPU kernel on a ported path with a
kernel written by hand for Hopper (``csrc/``, bound in :mod:`.kernels`).

Ported so far: LM serving, through the batcher or the continuous
scheduler over the paged KV pool, from random or checkpointed weights
(``python -m pytorch_distributed_training_tpu_torch.serving``), LM training at plain
data parallelism and on one card at long context, and ResNet training at
data parallelism on synthetic images (``python -m
pytorch_distributed_training_tpu_torch.train_distributed``).  Entry points
run on the card unless the caller asks for the CPU; :func:`resolve_device`
enforces it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is present: an entry point never carries on
    silently on the CPU.  The CPU is used only when the caller passes
    ``"cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the card; pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU instead"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev
