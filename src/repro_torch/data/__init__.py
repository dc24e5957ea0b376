"""Data pipeline of the port (numpy only)."""
from repro_torch.data.pipeline import make_batch_fn  # noqa: F401
