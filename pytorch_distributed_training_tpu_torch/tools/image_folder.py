"""Write a seeded ImageNet-layout JPEG tree, for runs without a dataset.

    python -m pytorch_distributed_training_tpu_torch.tools.image_folder ROOT \\
        [--classes 4] [--train 8] [--val 3] [--width 500] [--height 375] \\
        [--quality 90] [--seed 0]

``ROOT/train/<class>/*.JPEG`` and ``ROOT/val/<class>/*.JPEG`` with
``--train`` and ``--val`` images a class, classes named like ImageNet's
WordNet ids.  Each image is seeded coarse noise upsampled with PIL's
bilinear filter to ``--width`` x ``--height`` (500 x 375 is ImageNet's
typical size), plus a class-dependent colour shift so short runs have
something to learn, saved at JPEG ``--quality``.  The same seed writes
the same bytes.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["main", "write_image_folder"]


def write_image_folder(root: str, classes: int = 4, train: int = 8, val: int = 3,
                       width: int = 500, height: int = 375, quality: int = 90,
                       seed: int = 0) -> str:
    """Write the tree under ``root`` (see the module docstring); returns ``root``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, per_class in (("train", train), ("val", val)):
        for c in range(classes):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d, exist_ok=True)
            shift = np.array([(c * 37) % 96, (c * 71) % 96, (c * 13) % 96], np.int16) - 48
            for i in range(per_class):
                base = rng.integers(40, 216, size=(12, 16, 3)).astype(np.int16)
                base = np.clip(base + shift, 0, 255).astype(np.uint8)
                im = Image.fromarray(base).resize((width, height), Image.BILINEAR)
                im.save(os.path.join(d, f"{split}_{c:04d}_{i:05d}.JPEG"), "JPEG",
                        quality=quality)
    return root


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("root")
    parser.add_argument("--classes", type=int, default=4)
    parser.add_argument("--train", type=int, default=8, help="train images a class")
    parser.add_argument("--val", type=int, default=3, help="val images a class")
    parser.add_argument("--width", type=int, default=500)
    parser.add_argument("--height", type=int, default=375)
    parser.add_argument("--quality", type=int, default=90)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    write_image_folder(args.root, args.classes, args.train, args.val, args.width, args.height,
                       args.quality, args.seed)
    print(args.root)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
