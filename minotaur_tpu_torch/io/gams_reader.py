"""GAMS interface stub.

Reference: src/interfaces/gams/GAMSInstanceFactory.h — the reference
ships only a stub header (no implementation); this mirrors that surface
so option/driver code can reference the format uniformly.
"""

from __future__ import annotations


def read_gams(path: str):
    raise NotImplementedError(
        "GAMS input is not implemented (the reference ships only a stub "
        "header, GAMSInstanceFactory.h); convert to AMPL .nl or MPS")
