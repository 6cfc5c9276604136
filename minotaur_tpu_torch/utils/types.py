"""Core enums and type aliases for minotaur-tpu.

TPU-native re-design of the reference's type system
(reference: src/base/Types.h:47-230).  We keep the *semantics* of the
reference enums — the branch-and-bound logic depends on them — but the
representation is plain Python ``enum.IntEnum`` so values can cross the
host/device boundary as int32 scalars inside jax arrays.
"""

from __future__ import annotations

import enum


class ProblemType(enum.IntEnum):
    """Classification of a Problem (reference: Types.h:47-59)."""

    LP = 0
    MILP = 1
    QP = 2
    MIQP = 3
    QCQP = 4
    MIQCQP = 5
    POLYP = 6
    MIPOLYP = 7
    NLP = 8
    MINLP = 9
    OTHER = 10


class ObjectiveType(enum.IntEnum):
    """(reference: Types.h:60-64). Everything is converted to Minimize."""

    MINIMIZE = 0
    MAXIMIZE = 1


class FunctionType(enum.IntEnum):
    """Type of a function (reference: Types.h:66-77)."""

    CONSTANT = 0
    LINEAR = 1
    MULTILINEAR = 2
    QUADRATIC = 3
    POLYNOMIAL = 4
    NONLINEAR = 5
    OTHERFUNCTIONTYPE = 6


class VarType(enum.IntEnum):
    """Variable type (reference: Types.h:79-87)."""

    BINARY = 0
    INTEGER = 1
    IMPLBIN = 2
    IMPLINT = 3
    CONTINUOUS = 4


class BoundType(enum.IntEnum):
    LOWER = 0
    UPPER = 1


class SolveStatus(enum.IntEnum):
    """Status of the overall solve (reference: Types.h:134-151)."""

    NOT_STARTED = 0
    STARTED = 1
    RESTARTED = 2
    SOLVED_OPTIMAL = 3
    SOLVED_INFEASIBLE = 4
    SOLVED_UNBOUNDED = 5
    SOLVED_GAP_LIMIT = 6
    SOLVED_NODE_LIMIT = 7
    SOLVED_ITERATION_LIMIT = 8
    SOLVED_TIME_LIMIT = 9
    SOLVED_SOL_LIMIT = 10
    INTERRUPTED = 11
    FINISHED = 12


class EngineStatus(enum.IntEnum):
    """Status returned by a relaxation engine (reference: Types.h:152-166).

    The node-prune state machine (see bnb/processor.py) depends on these
    exact distinctions, so we keep them all even though the batched IPM
    engines only ever emit a subset.
    """

    NOT_SOLVED = 0
    SOLVED_OPTIMAL = 1
    SOLVED_INFEASIBLE = 2
    SOLVED_UNBOUNDED = 3
    ITERATION_LIMIT = 4
    TIME_LIMIT = 5
    FAILED_FEAS = 6
    FAILED_INFEAS = 7
    PROVEN_LOCAL_OPTIMAL = 8
    PROVEN_LOCAL_INFEASIBLE = 9
    ENGINE_ERROR = 10
    ENGINE_UNKNOWN_STATUS = 11


class BrancherStatus(enum.IntEnum):
    """(reference: Types.h:169-182)."""

    NOT_MODIFIED = 0
    MODIFIED_BY_BRANCHER = 1
    PRUNED_BY_BRANCHER = 2
    NO_CANDIDATES = 3


class NodeStatus(enum.IntEnum):
    """Lifecycle state of a B&B node (reference: Types.h:184-196)."""

    NOT_PROCESSED = 0
    ACTIVE = 1
    BRANCHED = 2
    PRUNED_BY_BOUND = 3
    PRUNED_INFEASIBLE = 4
    PRUNED_OPTIMAL = 5  # relaxation solution is feasible for the MINLP
    DOMINATED = 6


class SeparationStatus(enum.IntEnum):
    """Outcome of a separation round (reference: Types.h:198-206)."""

    CONTINUE = 0
    RESOLVE = 1
    PRUNE = 2
    NONE = 3
    ERROR = 4


class LogLevel(enum.IntEnum):
    """(reference: Types.h:207-215)."""

    NONE = 0
    ERROR = 1
    INFO = 2
    EXTRAINFO = 3
    DEBUG = 4
    DEBUG1 = 5
    DEBUG2 = 6


class TreeSearchOrder(enum.IntEnum):
    """Active-node selection rule (reference: Types.h:219-224)."""

    DFS = 0
    BFS = 1
    BEST_THEN_DIVE = 2


# Numeric constants (reference: Types.h INFINITY usage). We use a finite
# "infinity" for bound arrays that must live on device in float32/float64.
INF = float("inf")
