"""B&B node: a dense bound box + metadata.

The reference stores a node as parent pointer + two lists of bound
modifications replayed on demand (reference: Node.h:363-369,
Node::applyMods :122).  On TPU the node IS its (vlb, vub) vectors: replay,
serialization (Serializer.h:32-35) and the relaxation-switch machinery
(NodeIncRelaxer.cpp:94-155) all collapse into array slicing, and a batch of
nodes is just a (B, n) pair of arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..utils.types import NodeStatus


@dataclasses.dataclass
class Node:
    nid: int
    depth: int
    lb: float                       # inherited/proven lower bound
    vlb: np.ndarray                 # (n,) variable lower bounds
    vub: np.ndarray                 # (n,)
    warm_x: Optional[np.ndarray] = None   # parent relaxation solution
    warm_y: Optional[np.ndarray] = None   # parent row duals (dual warm
    #                                       start; IPM analogue of the
    #                                       reference's warm-started
    #                                       resolves, OsiLPEngine.cpp:591)
    status: NodeStatus = NodeStatus.NOT_PROCESSED
    branch_var: int = -1            # var whose branch created this node
    branch_dir: int = 0             # 0 = down child, 1 = up child
    branch_frac: float = 0.0        # |LP value - imposed bound| at parent
    tb_score: float = 0.0           # tie-break / requeue counter
    pred_iters: int = 0             # parent lane's IPM iteration count —
    #                                 a difficulty estimate the tree
    #                                 manager uses to compose iteration-
    #                                 homogeneous batches (a vmapped
    #                                 superstep runs at the pace of its
    #                                 slowest lane)
    vio_val: float = float("inf")   # parent's nl-violation score (QG ECP
    #                                 gating; reference Node::setVioVal)
    pc_trail: Optional[dict] = None  # PATH-local pseudocosts for the
    #                                 unambiguous reliability brancher
    #                                 (reference: the fork's per-node
    #                                 brCands_/pseudoUp_/pseudoDown_
    #                                 vectors, Node.h:168-259): var ->
    #                                 [pc_down, n_down, pc_up, n_up]
    #                                 observed along this node's ancestry;
    #                                 shared with children copy-on-write

    def __lt__(self, other: "Node") -> bool:  # heap ordering fallback
        return self.lb < other.lb
