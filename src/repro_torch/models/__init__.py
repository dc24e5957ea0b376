"""Models of the port: the dense decoder family's serve path."""
from repro_torch.models.model import Model, build_model  # noqa: F401
