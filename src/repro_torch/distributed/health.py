"""Health signals of the serve loop.

Copy of ``repro.distributed.health``: plain Python.  ``StragglerDetector``
flags a sustained slowdown from a per-step wall-time EWMA; the serve
loop's ``ShardHealth`` (``serve.resilience``) runs one per trie shard.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class StragglerDetector:
    """Per-step wall-time EWMA + deviation score; flags sustained
    slowdowns (the signal a real fleet uses to evict a slow host or
    demote a slow shard)."""

    alpha: float = 0.1            # EWMA weight
    threshold: float = 2.0        # flag when step > threshold × EWMA
    patience: int = 3             # consecutive slow steps before firing
    _ewma: Optional[float] = None
    _var: float = 0.0
    _slow_streak: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Returns True when a sustained straggle is detected."""
        if self._ewma is None:
            self._ewma = seconds
            return False
        slow = seconds > self.threshold * self._ewma
        if slow:
            self._slow_streak += 1
        else:
            self._slow_streak = 0
            self._ewma = (
                (1 - self.alpha) * self._ewma + self.alpha * seconds
            )
        if self._slow_streak >= self.patience:
            self.events.append(
                {"step": step, "seconds": seconds, "ewma": self._ewma}
            )
            self._slow_streak = 0
            return True
        return False
