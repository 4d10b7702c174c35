"""How far a ResNet training step's f32 gradients lie from float64, on the CPU.

    python -m pytorch_distributed_training_tpu_torch.tools.resnet_grad_drift \\
        [--model ResNet50] [--image-size 224] [--batch 4 16] [--bn port native two_pass]

One forward and backward of the port's train step (``sync_bn`` on, world
size 1) from seeded weights and images, once in f32 and once in float64
(the model's statistics and products in float64; logits and CE in f32 on
both sides, as the step computes them), and for each BatchNorm form:

- ``port``: the port's :class:`..ops.batch_norm.DistributedBatchNorm`
  (raw moments, the JAX package's sync form);
- ``native``: torch's ``F.batch_norm`` in its place;
- ``two_pass``: the variance as the mean of squared deviations.

Prints one JSON line per case: the norm-relative error of all gradients
together, how many gradient tensors lie beyond 1e-4 of their largest
magnitude, and the worst tensor.  ``chip_smoke.py`` phase 13 holds the
card's f32 gradients to the CPU's f32 error from float64 because this
error is large for ResNet-50 at its init, whatever the BatchNorm form.
"""
from __future__ import annotations

import argparse
import json
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from .. import optimizers
from ..engine import build_train_step
from ..models import get_model
from ..ops.batch_norm import DistributedBatchNorm

__all__ = ["gradient_drift", "main"]


def _native(self, x):
    return F.batch_norm(x, None, None, self.weight.to(x.dtype), self.bias.to(x.dtype), True,
                        self.momentum, self.eps)


def _two_pass(self, x):
    xf = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
    axes, shape = (0, 2, 3), (1, -1, 1, 1)
    centred = xf - xf.mean(axes).view(shape)
    inv = torch.rsqrt(centred.square().mean(axes) + self.eps)
    return (centred * inv.view(shape) * self.weight.view(shape)
            + self.bias.view(shape)).to(x.dtype)


FORMS = {"port": None, "native": _native, "two_pass": _two_pass}


@contextmanager
def _batch_norm_form(form: str):
    forward = DistributedBatchNorm.forward
    if FORMS[form] is not None:
        DistributedBatchNorm.forward = FORMS[form]
    try:
        yield
    finally:
        DistributedBatchNorm.forward = forward


def _grads(model_name, state, img, labels, dtype):
    model = get_model(model_name, num_classes=1000, sync_bn=True, dtype=dtype)
    model.load_state_dict(state)
    model.to(dtype)
    step = build_train_step(model, optimizers.SGD(lr=0.1), lambda s: 0.1, sync_bn=True)
    step.forward_backward(img.to(dtype), labels)
    return {n: p.grad.double() for n, p in model.named_parameters()}


def gradient_drift(model_name: str = "ResNet50", image_size: int = 224, batch: int = 4,
                   form: str = "port", seed: int = 12) -> dict:
    """The f32 gradients' distance from float64 for one step (CPU)."""
    ref = get_model(model_name, num_classes=1000)
    ref.reset_parameters(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    img = torch.randn(batch, image_size, image_size, 3, generator=gen)
    labels = torch.randint(0, 1000, (batch,), generator=gen)
    with _batch_norm_form(form):
        g32, g64 = (_grads(model_name, ref.state_dict(), img, labels, dt)
                    for dt in (torch.float32, torch.float64))
    rel = {n: ((g32[n] - g).abs().max() / g.abs().max()).item() for n, g in g64.items()}
    diff = sum(((g32[n] - g) ** 2).sum() for n, g in g64.items()).sqrt()
    total = sum((g ** 2).sum() for g in g64.values()).sqrt()
    worst = max(rel, key=rel.get)
    return dict(model=model_name, image_size=image_size, batch=batch, bn=form,
                norm_rel_all=(diff / total).item(), tensors=len(rel),
                beyond_1e_4=sum(v > 1e-4 for v in rel.values()), worst=[worst, rel[worst]])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", default="ResNet50")
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--batch", type=int, nargs="+", default=[4, 16])
    parser.add_argument("--bn", nargs="+", choices=sorted(FORMS), default=sorted(FORMS))
    args = parser.parse_args(argv)
    for batch in args.batch:
        for form in args.bn:
            print(json.dumps(gradient_drift(args.model, args.image_size, batch, form)),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
