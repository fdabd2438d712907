"""Host-side data pipeline of the port: the model zoo's deterministic
synthetic training batches (``synthetic_batch``, ``batch_iterator``,
bit for bit the reference's) and ``prefetch_iterator``."""

from repro_torch.data.pipeline import DataConfig, batch_iterator, prefetch_iterator, synthetic_batch

__all__ = ["DataConfig", "batch_iterator", "prefetch_iterator", "synthetic_batch"]
