"""Seeding shared by the generators."""

from __future__ import annotations

import numpy as np


def instance_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of instance `index` in the stream of run seed `seed`.
    Any whole number is a seed: it is taken modulo 2**64."""
    return np.random.default_rng([int(seed) % 2 ** 64, int(index)])
