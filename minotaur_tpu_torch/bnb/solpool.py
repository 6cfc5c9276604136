"""Best-k solution pool.

Reference: SolutionPool.{h,cpp} (SolutionPool.h:40-89 — best-k feasible
solutions + best value) and Solution.{h,cpp}.  Host-side: solutions are
small (n,) vectors harvested from device batches.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

import numpy as np


class SolutionPool:
    def __init__(self, capacity: int = 10):
        self.capacity = max(1, int(capacity))
        self._sols: List[Tuple[float, np.ndarray]] = []  # sorted by value
        self.num_added = 0
        self.best_seen = float("inf")

    def add(self, x: np.ndarray, value: float) -> bool:
        """Insert if it improves the pool; dedup near-identical points."""
        value = float(value)
        self.best_seen = min(self.best_seen, value)
        if len(self._sols) >= self.capacity and \
                value >= self._sols[-1][0] - 1e-12:
            return False
        for v, s in self._sols:
            if abs(v - value) <= 1e-9 * (1 + abs(value)) and \
                    np.allclose(s, x, atol=1e-7):
                return False
        keys = [v for v, _ in self._sols]
        i = bisect.bisect_right(keys, value)
        self._sols.insert(i, (value, np.asarray(x, dtype=np.float64).copy()))
        if len(self._sols) > self.capacity:
            self._sols.pop()
        self.num_added += 1
        return True

    def best(self) -> Optional[Tuple[float, np.ndarray]]:
        return self._sols[0] if self._sols else None

    def best_value(self) -> float:
        return self._sols[0][0] if self._sols else float("inf")

    def solutions(self) -> List[Tuple[float, np.ndarray]]:
        return list(self._sols)

    def values(self) -> List[float]:
        return [v for v, _ in self._sols]

    def __len__(self) -> int:
        return len(self._sols)
