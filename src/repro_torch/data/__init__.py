from .pipeline import PrefetchIterator, SyntheticTokenDataset, to_device

__all__ = ["PrefetchIterator", "SyntheticTokenDataset", "to_device"]
