"""Models of the port: the dense decoder and Mamba-1 SSM families'
forward, prefill and decode."""
from repro_torch.models.model import Model, build_model  # noqa: F401
from repro_torch.models.runtime import Runtime  # noqa: F401
