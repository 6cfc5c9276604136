"""Free-standing numeric helpers (reference: src/base/Operations.h)."""

from __future__ import annotations

import math


def gcd(a: float, b: float, tol: float = 1e-9) -> float:
    """GCD of two doubles (reference: Operations.cpp Gcd)."""
    a, b = abs(a), abs(b)
    if a < b:
        a, b = b, a
    while b > tol:
        a, b = b, a - math.floor(a / b) * b
    return a


def is_int(x: float, tol: float = 1e-6) -> bool:
    return abs(x - round(x)) <= tol


def to_clock_time(seconds: float) -> str:
    m, s = divmod(seconds, 60.0)
    h, m = divmod(int(m), 60)
    return f"{h:02d}:{m:02d}:{s:06.3f}"
