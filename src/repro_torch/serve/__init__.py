"""Serving steps of the port."""
from repro_torch.serve.engine import (  # noqa: F401
    make_prefill_step, make_serve_step)
