"""What one run hands the metric readers (``metrics/<name>.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from portbench.devtrace import DeviceTrace
from portbench.load import Window


@dataclass
class Record:
    cfg: dict                     # the configuration as run
    traffic: dict                 # the traffic mix
    window: Window                # every request of the window, timed
    setup_s: float                # process start to the first request
    before: Dict[str, object]     # the program's counters at the start
    after: Dict[str, object]      # ... and at the close
    trace: Optional[DeviceTrace]  # the profiled window

    def delta(self, key: str) -> float:
        return self.after[key] - self.before[key]

    def stage_delta_s(self) -> float:
        """Seconds the host stages spent in the window's batches."""
        a, b = self.after["stage_s"], self.before["stage_s"]
        return sum(v - b.get(k, 0.0) for k, v in a.items())
