"""Fused softmax cross-entropy, forward and backward, each one kernel.

Port of ``pytorch_distributed_training_tpu/ops/fused_ce.py``:

- :func:`fused_ce_forward`: per row of ``logits [B, C]``, ``lse`` and
  ``nll = lse - logits[label]``, both [B] f32, computed in f32 whatever the
  logits dtype.  Replaces the TPU kernel ``_fwd_kernel``
  (``ops/fused_ce.py:56``, launched at ``:108``).
- :func:`fused_ce_backward`: ``(exp(x - lse) - onehot) * g`` in the logits
  dtype, ``g`` a one-element f32 device tensor (the mean's ``1/B`` folded in
  by the caller).  Replaces ``_bwd_kernel`` (``:70``, launched at ``:143``).
- :func:`fused_cross_entropy`: the mean, as a ``torch.autograd.Function``
  whose forward and backward are the two wrappers above.

An out-of-range label contributes a true logit of 0, a finite wrong loss,
exactly as the TPU kernel's iota compare does (``fused_ce.py:64-65``,
``:168-172``); ``F.cross_entropy`` would raise instead.

On a CUDA tensor each wrapper checks its inputs, launches its kernel
(``csrc/fused_ce.cu``) on the current stream, adds one to its
``launches`` count, and raises on anything the kernel does not take.  On a
CPU tensor it computes the plain twin (:func:`ce_forward_plain`,
:func:`ce_backward_plain`).  Both kernels are bound by bytes:
:func:`ce_forward_bytes` and :func:`ce_backward_bytes` count each input
read once and each output written once.
"""
from __future__ import annotations

import torch

from .. import kernels

__all__ = [
    "KERNELS",
    "ce_backward_bytes",
    "ce_backward_plain",
    "ce_forward_bytes",
    "ce_forward_plain",
    "fused_ce_backward",
    "fused_ce_forward",
    "fused_cross_entropy",
    "launch_counts",
    "reset_launch_counts",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _true_logit(x32, labels):
    """``x[label]`` per row, 0 where the label lies outside ``[0, C)``."""
    c = x32.shape[-1]
    valid = (labels >= 0) & (labels < c)
    got = x32.gather(1, labels.clamp(0, c - 1).long()[:, None])[:, 0]
    return torch.where(valid, got, torch.zeros_like(got))


def ce_forward_plain(logits, labels):
    """The plain twin of :func:`fused_ce_forward`: ``(nll, lse)`` [B] f32."""
    x = logits.float()
    m = x.amax(-1, keepdim=True)
    lse = (m + torch.log(torch.exp(x - m).sum(-1, keepdim=True)))[:, 0]
    return lse - _true_logit(x, labels), lse


def ce_backward_plain(logits, labels, lse, scale):
    """The plain twin of :func:`fused_ce_backward`."""
    x = logits.float()
    p = torch.exp(x - lse[:, None])
    col = torch.arange(x.shape[-1], device=x.device)
    onehot = (col[None, :] == labels.long()[:, None]).float()
    return ((p - onehot) * scale.float().reshape(())).to(logits.dtype)


def ce_forward_bytes(rows: int, classes: int, dtype) -> int:
    """Least traffic: read logits and labels once, write nll and lse."""
    es = torch.empty((), dtype=dtype).element_size()
    return rows * classes * es + rows * 4 + 2 * rows * 4


def ce_backward_bytes(rows: int, classes: int, dtype) -> int:
    """Least traffic: read logits, labels and lse once, write dlogits."""
    es = torch.empty((), dtype=dtype).element_size()
    return 2 * rows * classes * es + 2 * rows * 4 + 4


def _check(name: str, logits, labels) -> None:
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16 logits, "
                        f"got {logits.dtype}")
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"{name}: logits must be [B, C] and labels [B], got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: labels must be int32 or int64, got {labels.dtype}")
    if logits.shape[1] < 1:
        raise ValueError(f"{name}: empty class axis")
    kernels.require_contiguous(name, logits)
    kernels.require_cuda(name, logits, labels)


def fused_ce_forward(logits, labels):
    """``(nll, lse)``, each [B] f32, of ``logits [B, C]`` and ``labels [B]``."""
    if logits.device.type == "cpu":
        return ce_forward_plain(logits, labels)
    name = "fused_ce_forward"
    _check(name, logits, labels)
    rows, classes = logits.shape
    nll = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(nll)
    if rows == 0:
        return nll, lse
    lab = labels.to(torch.int32).contiguous()
    lib = kernels.library("fused_ce")
    with torch.cuda.device(logits.device):
        err = lib.pdt_ce_fwd(logits.data_ptr(), lab.data_ptr(), nll.data_ptr(),
                             lse.data_ptr(), rows, classes, _DTYPE_CODES[logits.dtype],
                             kernels.stream(logits))
    kernels.check(err, name)
    fused_ce_forward.launches += 1
    return nll, lse


fused_ce_forward.launches = 0


def fused_ce_backward(logits, labels, lse, scale):
    """``dlogits = (softmax(logits) - onehot(labels)) * scale`` in the logits
    dtype; ``lse`` [B] f32 from the forward, ``scale`` a one-element f32
    tensor on the logits' device."""
    if logits.device.type == "cpu":
        return ce_backward_plain(logits, labels, lse, scale)
    name = "fused_ce_backward"
    _check(name, logits, labels)
    rows, classes = logits.shape
    if lse.dtype != torch.float32 or lse.shape != (rows,):
        raise ValueError(f"{name}: lse must be [{rows}] float32")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError(f"{name}: scale must be one float32 element")
    kernels.require_contiguous(name, lse)
    kernels.require_cuda(name, logits, lse, scale)
    dlogits = torch.empty_like(logits)
    if rows == 0:
        return dlogits
    lab = labels.to(torch.int32).contiguous()
    lib = kernels.library("fused_ce")
    with torch.cuda.device(logits.device):
        err = lib.pdt_ce_bwd(logits.data_ptr(), lab.data_ptr(), lse.data_ptr(),
                             scale.data_ptr(), dlogits.data_ptr(), rows, classes,
                             _DTYPE_CODES[logits.dtype], kernels.stream(logits))
    kernels.check(err, name)
    fused_ce_backward.launches += 1
    return dlogits


fused_ce_backward.launches = 0


class _FusedCrossEntropy(torch.autograd.Function):
    """Mean CE; the backward recomputes the softmax from the saved lse, as
    the JAX ``custom_vjp`` does (``fused_ce.py:127-158``)."""

    @staticmethod
    def forward(ctx, logits, labels):
        nll, lse = fused_ce_forward(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return nll.mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        # the mean's 1/B folded into the upstream gradient once, on the device
        scale = (g.float() / logits.shape[0]).reshape(1)
        return fused_ce_backward(logits, labels, lse, scale), None


def fused_cross_entropy(logits, labels):
    """Mean softmax CE of ``logits [B, C]`` against integer ``labels [B]``,
    computed in f32; differentiable in ``logits``.  Every label must lie in
    ``[0, C)`` (see the module docstring for what happens otherwise)."""
    if torch.is_grad_enabled() and logits.requires_grad:
        return _FusedCrossEntropy.apply(logits, labels)
    return fused_ce_forward(logits, labels)[0].mean()


# every kernel wrapper of this module, by the name its launch count goes by
KERNELS = {"ce_fwd": fused_ce_forward, "ce_bwd": fused_ce_backward}


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
