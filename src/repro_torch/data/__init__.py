from .pipeline import Prefetcher, SyntheticDataset  # noqa: F401
