"""Vision Transformer family, ViT-Ti/S/B/16 (port of ``models/vit.py``).

torchvision's ``VisionTransformer`` topology with the JAX package's
numerics and flax's parameter names (``patch_embed``, ``cls_token``,
``pos_embedding``, ``block{i}.{ln1,attn,ln2,mlp}``, ``ln``, ``head``;
:mod:`.from_jax` maps the flax tree, :mod:`.torch_port` a torchvision
``state_dict``):

- a stride-``patch`` conv cuts the ``[N, 3, H, W]`` image into patches;
  the grid flattens row-major ``(h, w)`` as the JAX model's NHWC reshape
  does (``conv -> flatten(2) -> transpose(1, 2)``; on a ``channels_last``
  input the two are views);
- a learned class token and position embeddings, both stored in float32
  and cast to the compute dtype before the concat and the add;
- pre-LN encoder blocks: flax LayerNorm (eps 1e-6), non-causal
  :class:`..ops.attention.MultiHeadAttention` with the heads-major qkv
  layout of the LM, and an exact-erf GELU :class:`MLP` without fused
  tails (the JAX ``EncoderBlock`` never sets them);
- a final LayerNorm and an f32 head on the class token's row.

Every Dense and the patch conv compute in ``dtype`` over float32
parameters (flax ``promote_dtype``).  Attention is the f32 einsum: the
sequence is ``(H / patch)^2 + 1`` tokens, never a multiple of 128, so the
JAX package's flash gate (``flash_shapes_ok``) never passes for a ViT.
Init follows flax's distributions: lecun-normal kernels (the conv's
fan-in is ``3 * patch^2``), zero biases, a zero class token and
``normal(0.02)`` position embeddings.

The position table's length follows from ``image_size`` (flax infers it
from the init input).  ``axis_name``, ``sync_bn`` and ``group`` are
accepted for ``get_model``'s signature and unused: a ViT has no batch
statistics.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import MultiHeadAttention
from ..ops.fused_elementwise import FusedDenseGelu
from ..ops.layers import Dense, LayerNorm, lecun_normal_

__all__ = ["EncoderBlock", "MLP", "PatchEmbed", "VIT_CONFIGS", "ViT"]


class MLP(nn.Module):
    """``fc2(gelu(fc1(x)))`` with exact-erf GELU.

    ``fused_tails`` makes fc1's bias add and GELU one kernel
    (:class:`..ops.fused_elementwise.FusedDenseGelu`); the parameters are
    the same either way.  ``tensor_group`` makes fc1 column-parallel and
    fc2 row-parallel (Megatron's MLP: each rank holds ``hidden / T`` of the
    hidden units; :mod:`..parallel.tensor`).
    """

    def __init__(self, dim: int, hidden: int, out: int, dtype=torch.float32,
                 fused_tails: bool = False, tensor_group=None):
        super().__init__()
        self.fused_tails = fused_tails
        self.fc1 = (FusedDenseGelu if fused_tails else Dense)(dim, hidden, dtype, tensor_group,
                                                              "column")
        self.fc2 = Dense(hidden, out, dtype, tensor_group, "row")

    def forward(self, x):
        if self.fused_tails:
            return self.fc2(self.fc1(x))
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class PatchEmbed(nn.Module):
    """flax ``nn.Conv(embed, (p, p), strides=(p, p), padding="VALID")``:
    ``weight`` ``[embed, 3, p, p]`` (OIHW), ``bias`` ``[embed]``."""

    def __init__(self, in_ch: int, embed_dim: int, patch: int, dtype=torch.float32):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(embed_dim, in_ch, patch, patch))
        self.bias = nn.Parameter(torch.zeros(embed_dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        d = self.dtype
        return F.conv2d(x.to(d), self.weight.to(d), self.bias.to(d), stride=self.patch)


class EncoderBlock(nn.Module):
    """Pre-LN: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, dtype=torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype)
        self.attn = MultiHeadAttention(dim, num_heads, causal=False, dtype=dtype)
        self.ln2 = LayerNorm(dim, dtype)
        self.mlp = MLP(dim, int(dim * mlp_ratio), dim, dtype)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT(nn.Module):
    """ViT classifier: ``[N, 3, H, W] -> logits [N, num_classes]`` (f32)."""

    def __init__(self, num_classes: int, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 image_size: int = 224, dtype=torch.float32, axis_name: Optional[str] = None,
                 sync_bn: bool = False, group=None):
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image {image_size}x{image_size} not divisible by patch size "
                             f"{patch_size}")
        self.num_classes = int(num_classes)
        self.patch_size = int(patch_size)
        self.embed_dim = int(embed_dim)
        self.depth = int(depth)
        self.num_heads = int(num_heads)
        self.image_size = int(image_size)
        self.dtype = dtype
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size, dtype)
        tokens = (image_size // patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, tokens, embed_dim))
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(embed_dim, num_heads, mlp_ratio, dtype))
        self.ln = LayerNorm(embed_dim, dtype)
        self.head = Dense(embed_dim, num_classes, torch.float32)
        # the submodules initialised themselves; the embeddings are ours
        if not self.pos_embedding.is_meta:
            with torch.no_grad():
                self.pos_embedding.normal_(0.0, 0.02)

    @property
    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers, drawn in a fixed module order from ``generator``."""
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embedding.normal_(0.0, 0.02, generator=generator)
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def forward(self, x):
        b, _, h, w = x.shape
        ps = self.patch_size
        if h % ps or w % ps:
            raise ValueError(f"image {h}x{w} not divisible by patch size {ps}")
        d = self.dtype
        # [B, E, h/ps, w/ps] -> [B, (h/ps)(w/ps), E], row-major over (h, w)
        tokens = self.patch_embed(x).flatten(2).transpose(1, 2)
        cls = self.cls_token.to(d).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, tokens], dim=1)
        if x.shape[1] != self.pos_embedding.shape[1]:
            raise ValueError(f"image {h}x{w} gives {x.shape[1]} tokens; the position table "
                             f"holds {self.pos_embedding.shape[1]} (image_size "
                             f"{self.image_size})")
        x = x + self.pos_embedding.to(d)
        for block in self.blocks:
            x = block(x)
        # LayerNorm is per token: the class token's row alone feeds the head
        return self.head(self.ln(x[:, 0]))


# name -> (patch, embed, depth, heads); ViT-B/16 matches torchvision vit_b_16
VIT_CONFIGS = {
    "ViT-Ti16": (16, 192, 12, 3),
    "ViT-S16": (16, 384, 12, 6),
    "ViT-B16": (16, 768, 12, 12),
}
