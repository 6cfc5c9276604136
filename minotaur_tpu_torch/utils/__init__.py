from .environment import Environment
from .logger import Logger
from .options import Option, OptionDB
from .timer import Timer, TimerFactory
from .types import (
    INF,
    BoundType,
    BrancherStatus,
    EngineStatus,
    FunctionType,
    LogLevel,
    NodeStatus,
    ObjectiveType,
    ProblemType,
    SeparationStatus,
    SolveStatus,
    TreeSearchOrder,
    VarType,
)

__all__ = [
    "Environment", "Logger", "Option", "OptionDB", "Timer", "TimerFactory",
    "INF", "BoundType", "BrancherStatus", "EngineStatus", "FunctionType",
    "LogLevel", "NodeStatus", "ObjectiveType", "ProblemType",
    "SeparationStatus", "SolveStatus", "TreeSearchOrder", "VarType",
]
