"""Checkpoint / resume of the branch-and-bound search state.

The reference has none (SURVEY.md §5: "Checkpoint/resume: none"), but its
fork's Serializer (node = Branch + VarBoundMods, Serializer.h:32-35) is
the natural seed.  Here a node is already two dense vectors, so the whole
open pool checkpoints as a handful of stacked arrays in one np.savez —
{incumbent, global bound, open node pool as bound arrays} exactly as
SURVEY.md §5 prescribes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .node import Node

FORMAT_VERSION = 1


def save_checkpoint(path: str, bab) -> None:
    """Snapshot a BranchAndBound(-derived) search.  Includes any nodes
    the pipelined driver currently holds in flight (they are popped from
    the tree; losing them would drop subtrees on resume)."""
    nodes: List[Node] = list(bab.tm.iter_nodes()) + \
        list(getattr(bab, "_inflight_nodes", []))
    n = bab.sp.n
    if nodes:
        vlb = np.stack([nd.vlb for nd in nodes])
        vub = np.stack([nd.vub for nd in nodes])
        lbs = np.array([nd.lb for nd in nodes])
        depths = np.array([nd.depth for nd in nodes], dtype=np.int64)
        nids = np.array([nd.nid for nd in nodes], dtype=np.int64)
        warm = np.stack([nd.warm_x if nd.warm_x is not None
                         else np.full(n, np.nan) for nd in nodes])
    else:
        vlb = np.zeros((0, n))
        vub = np.zeros((0, n))
        lbs = np.zeros(0)
        depths = np.zeros(0, dtype=np.int64)
        nids = np.zeros(0, dtype=np.int64)
        warm = np.zeros((0, n))
    extra = {}
    if hasattr(bab, "mA"):  # QG cut pool
        extra = {"cut_A": bab.mA[bab._cut_base:bab._cut_base + bab.n_cuts],
                 "cut_lb": bab.mclb[bab._cut_base:bab._cut_base + bab.n_cuts],
                 "cut_ub": bab.mcub[bab._cut_base:bab._cut_base + bab.n_cuts]}
    np.savez_compressed(
        path, version=FORMAT_VERSION, ub=bab.ub, lb=bab.lb,
        best_x=(bab.best_x if bab.best_x is not None else np.full(0, np.nan)),
        unresolved_lb=bab.unresolved_lb,
        nodes_processed=bab.stats.nodes_processed
        if hasattr(bab, "stats") else 0,
        vlb=vlb, vub=vub, lbs=lbs, depths=depths, nids=nids, warm=warm,
        **extra)
    # np.savez appends ".npz" to extension-less paths, which would break
    # resume (the driver looks for checkpoint_file verbatim)
    import os
    if not str(path).endswith(".npz") and os.path.exists(f"{path}.npz"):
        os.replace(f"{path}.npz", path)


def load_checkpoint(path: str, bab) -> None:
    """Restore pool + incumbent into a freshly constructed search object
    for the SAME instance."""
    data = np.load(path, allow_pickle=False)
    assert int(data["version"]) == FORMAT_VERSION
    bab.ub = float(data["ub"])
    bab.lb = float(data["lb"])
    bab.unresolved_lb = float(data["unresolved_lb"])
    bx = data["best_x"]
    bab.best_x = bx if bx.size else None
    bab.tm.clear()
    for k in range(data["vlb"].shape[0]):
        warm = data["warm"][k]
        node = Node(nid=int(data["nids"][k]), depth=int(data["depths"][k]),
                    lb=float(data["lbs"][k]), vlb=data["vlb"][k].copy(),
                    vub=data["vub"][k].copy(),
                    warm_x=None if np.any(np.isnan(warm)) else warm.copy())
        bab.tm.insert_candidate(node)
    if hasattr(bab, "mA") and "cut_A" in data:
        k = data["cut_A"].shape[0]
        bab.mA[bab._cut_base:bab._cut_base + k] = data["cut_A"]
        bab.mclb[bab._cut_base:bab._cut_base + k] = data["cut_lb"]
        bab.mcub[bab._cut_base:bab._cut_base + k] = data["cut_ub"]
        bab.n_cuts = k
