"""The measured-window roofline of the port: the card's model (``hw``),
per-window cost counted on fake tensors (``cost``), the scheduler-driven
capture (``capture``) and the report over its records (``report``)."""
from repro_torch.roofline.hw import HW_H100, Hardware  # noqa: F401
from repro_torch.roofline.capture import (  # noqa: F401
    WindowCapture, save_measured)
