"""Data pipeline of the port: the synthetic LM corpus, the samplers and a
plain batch loader (see each module)."""
from .datasets import SyntheticTextDataset, get_dataset
from .loader import DataLoader, make_iter_dataloader
from .sampler import DistributedShardSampler

__all__ = [
    "DataLoader",
    "DistributedShardSampler",
    "SyntheticTextDataset",
    "get_dataset",
    "make_iter_dataloader",
]
