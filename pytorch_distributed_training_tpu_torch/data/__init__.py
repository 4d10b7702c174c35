"""Data pipeline of the port: the synthetic image and LM datasets, the samplers and a
plain batch loader (see each module)."""
from .datasets import SyntheticDataset, SyntheticTextDataset, get_dataset
from .loader import DataLoader, make_iter_dataloader
from .sampler import DistributedShardSampler

__all__ = [
    "DataLoader",
    "DistributedShardSampler",
    "SyntheticDataset",
    "SyntheticTextDataset",
    "get_dataset",
    "make_iter_dataloader",
]
