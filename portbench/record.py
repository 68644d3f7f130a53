"""What the metric readers read of one run (``metrics/<metric>.py``'s
``read(run)``)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Run:
    """The harness fills the window's fields; the cell's program kind
    (``programs/<kind>.py``) fills those it has, through its session's
    ``run_fields()`` and its reference's ``work_per_frame()``, and leaves
    the others None, where their readers read nothing."""
    config: dict
    mix: dict
    samples_per_frame: int
    setup_s: float
    window_start: float = 0.0
    frames: List[tuple] = dataclasses.field(default_factory=list)
    trace: Optional[object] = None         # tracing.TraceRecord
    diffuse: Optional[bool] = None
    guide_ms: Optional[List[float]] = None
    work: Optional[dict] = None
