from .glob_bnb import GlobBranchAndBound
from .transformer import GlobStaged, is_convex_quadratic, transform

__all__ = ["GlobBranchAndBound", "GlobStaged", "is_convex_quadratic",
           "transform"]
