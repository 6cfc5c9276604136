"""intquad(n, u): a separable convex MIQP with one budget row.

    min  sum_i q_i (x_i - t_i)^2   s.t.  sum_i x_i <= b,  x integer in [0, u]^n

`data` is a frozen copy of the port's instance data
(`minotaur_tpu_torch/models/convex_suite2.py::_intquad_data`): q_i uniform in
[0.5, 2], t_i uniform in [0, u], b = floor(0.42 n u).  The benchmark draws
one instance from the configuration's `instance_seed`; the run's seed only
permutes its variables, so every seed poses the same problem in another
order (the root gap of intquad(300, 4) ranges from 0.37 to 0.67 over
instance seeds, which would swamp any change the benchmark should see).
"""

from __future__ import annotations

import math

import numpy as np

from .common import instance_rng


def data(n: int, u: int, seed: int):
    """(q, t, b) exactly as the port's `_intquad_data(n, u, seed)`."""
    rng = np.random.default_rng(seed)
    qd = rng.uniform(0.5, 2.0, size=n)
    t = rng.uniform(0.0, float(u), size=n)
    b = int(math.floor(0.42 * n * u))
    return qd, t, b


def generate(sizes: dict, instance_seed: int, seed: int, index: int) -> dict:
    """Instance `index` of the stream of run seed `seed`."""
    n, u = int(sizes["n"]), int(sizes["u"])
    qd, t, b = data(n, u, instance_seed)
    perm = instance_rng(seed, index).permutation(n)
    qd, t = qd[perm], t[perm]
    return dict(
        name=f"intquad_{n}_{u}",
        lb=np.zeros(n), ub=np.full(n, float(u)), vtype=["I"] * n,
        c=-2.0 * qd * t, const=float((qd * t * t).sum()),
        qi=np.arange(n), qj=np.arange(n), qv=qd.copy(),
        A=np.ones((1, n)), rlo=np.array([-np.inf]), rhi=np.array([float(b)]),
        family=dict(q=qd, t=t, b=float(b), u=float(u)), perm=perm)
