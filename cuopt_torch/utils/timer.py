"""Solve timer, mirroring reference cpp/src/utilities/timer.hpp (timer_t:26).

The timer carries the global time limit for a solve and answers
"how much is left" / "has it expired" for cooperative checks at major
iterations.
"""

from __future__ import annotations

import math
import time


class Timer:
    def __init__(self, time_limit_s: float = math.inf):
        self.time_limit = float(time_limit_s)
        self.start = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self.start

    def remaining(self) -> float:
        return self.time_limit - self.elapsed()

    def expired(self) -> bool:
        return self.elapsed() >= self.time_limit
