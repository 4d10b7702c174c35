"""Data pipeline of the port: the ImageFolder, synthetic image, LM and
token-file datasets, the samplers, the batch loader with its native,
thread and process backends, and device prefetch (see each module)."""
from .datasets import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImageFolderDataset,
    SyntheticDataset,
    SyntheticTextDataset,
    TokenFileDataset,
    get_dataset,
)
from .loader import DataLoader, make_iter_dataloader
from .prefetch import PinnedStager, device_prefetch
from .sampler import DistributedShardSampler

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "DataLoader",
    "DistributedShardSampler",
    "ImageFolderDataset",
    "PinnedStager",
    "SyntheticDataset",
    "SyntheticTextDataset",
    "TokenFileDataset",
    "device_prefetch",
    "get_dataset",
    "make_iter_dataloader",
]
