"""Host-side data pipeline of the port.  ``prefetch_iterator`` only: the
model zoo's synthetic batches wait for the model-family slices (ROADMAP
Queue 1 item 9)."""

from repro_torch.data.pipeline import prefetch_iterator

__all__ = ["prefetch_iterator"]
