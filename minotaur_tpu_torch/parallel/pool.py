"""Partitioned node-pool processing over a list of devices.

Re-derivation of the reference's distributed layer
(reference: MpiBranchAndBound.{h,cpp}):

- the MPI fork gossips incumbents with async Isend/Iprobe (tag 1,
  MpiBranchAndBound.cpp:197-208/36-50) -> here every superstep takes
  the min of the partitions' best integer-feasible objectives with the
  caller's bound, deterministically;
- LoadBalance_ pops the 50*P best nodes, Allgathers their bounds, sorts,
  and deals round-robin (:78-195) -> here the pool is a batch of (B, n)
  boxes split into one contiguous slice of lanes per partition, so
  "migration" is a move between host pools and the host-side deal
  (deal_round_robin) is the same global-sort round-robin;
- termination: all-bounds-infinite (:137-140) -> every pool empty.

A node is already a fixed-width (vlb, vub) pair, so the Serializer
(Serializer.h:32-35) has no equivalent here: migration never serializes.

Port of minotaur_tpu/parallel/pool.py.  The JAX package shards the batch
over a mesh with `shard_map` (one `vmap` per shard) and fuses the bound
with `pmin`; here each partition is one lane-batched `step_b` call on its
slice of lanes, on its device, and the fused bound is a min over the
partitions' scalars.  The devices may repeat: P partitions on one card
are the counterpart of the JAX tests' virtual CPU mesh.  Partitions on
distinct devices run one after another, not at once: the IPM loop reads
its `active` mask on the host every iteration (`engines/ipm.py::_while`),
so each call holds the host until its device is done.  Overlap across
cards comes from `parallel/multihost.py`, one process per card.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..bnb.step import (StepOptions, build_node_step_unjitted,
                        pack_step_result, unpack_step_result)
from ..device import DeviceLike, resolve_device
from ..engines.ipm import to_device
from ..engines.staging import StagedProblem


def _normalize(device: DeviceLike) -> torch.device:
    """resolve_device, with a bare "cuda" bound to the current card so
    that "cuda" and "cuda:0" name one partition device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_sharded_step(sp: StagedProblem, opts: StepOptions,
                       devices: Sequence[DeviceLike]) -> Callable:
    """Returns sharded_step(A, clb, cub, vlb_b, vub_b, x0_b, y0_b, ub_in)
    -> (StepResult with host numpy leaves, global_ub float).

    The B lanes split into P = len(devices) contiguous slices of B/P
    lanes, and slice p runs as one superstep on devices[p]; (A, clb, cub)
    are replicated to each distinct device once, and again when the
    caller passes new tensors (QG's cut pool makes new device copies at
    each cut epoch).  Each slice takes the min of `obj` over its lanes
    with `int_feasible & status == 1`; the global bound is the min of
    those and `ub_in`, the deterministic replacement for the reference's
    async incumbent gossip (MpiBranchAndBound.cpp:197-208).  Row duals
    warm-start per lane, as in the single-device driver.  Each slice's
    outputs and its best objective pack into one tensor, so a superstep
    costs one device-to-host copy per slice.

    `sharded_step.dispatch` runs the slices and returns a handle (the
    packed device tensors and ub_in); `sharded_step.unpack(handle)`
    makes the copies and returns (StepResult, global_ub)."""
    devs = [_normalize(d) for d in devices]
    if not devs:
        raise ValueError("build_sharded_step: empty device list")
    P = len(devs)
    n, m = sp.n, sp.m
    steps = {d: build_node_step_unjitted(sp, opts, d) for d in dict.fromkeys(devs)}
    replicas = {"src": None, "per_dev": {}}

    def consts(A, clb, cub):
        """(A, clb, cub) on each distinct device; cached only for torch
        inputs (a numpy array may be edited in place between calls)."""
        src = (A, clb, cub)
        cached = replicas["src"]
        if cached is not None and all(a is b for a, b in zip(cached, src)):
            return replicas["per_dev"]
        per_dev = {d: (to_device(A, d).reshape(m, n), to_device(clb, d),
                       to_device(cub, d)) for d in steps}
        if all(isinstance(a, torch.Tensor) for a in src):
            replicas["src"], replicas["per_dev"] = src, per_dev
        return per_dev

    def dispatch(A, clb, cub, vlb_b, vub_b, x0_b, y0_b=None, ub_in=np.inf):
        B = vlb_b.shape[0]
        if B % P:
            raise ValueError(f"sharded step: {B} lanes do not split into "
                             f"{P} partitions")
        if y0_b is None:
            y0_b = np.zeros((B, m))
        per = B // P
        reps = consts(A, clb, cub)
        parts = []
        for p, dev in enumerate(devs):
            lo, hi = p * per, (p + 1) * per
            res = steps[dev](*reps[dev], to_device(vlb_b[lo:hi], dev),
                             to_device(vub_b[lo:hi], dev),
                             to_device(x0_b[lo:hi], dev),
                             to_device(y0_b[lo:hi], dev).reshape(per, m))
            ok = res["int_feasible"] & (res["status"] == 1)
            best = torch.where(ok, res["obj"], torch.inf).amin()
            parts.append(torch.cat([pack_step_result(res).reshape(-1),
                                    best.reshape(1)]))
        return parts, float(ub_in)

    def unpack(handle):
        parts, ub_in = handle
        host = [t.cpu().numpy() for t in parts]
        packed = np.concatenate([h[:-1].reshape(-1, 4 * n + m + 10)
                                 for h in host])
        gub = min([float(h[-1]) for h in host] + [ub_in])
        return unpack_step_result(packed, n, m), gub

    def sharded_step(A, clb, cub, vlb_b, vub_b, x0_b, y0_b=None,
                     ub_in=np.inf):
        return unpack(dispatch(A, clb, cub, vlb_b, vub_b, x0_b, y0_b, ub_in))

    sharded_step.dispatch = dispatch
    sharded_step.unpack = unpack
    sharded_step.devices = devs
    return sharded_step


def deal_round_robin(lbs: np.ndarray, n_parts: int) -> np.ndarray:
    """Deterministic global deal: sort node bounds ascending, assign
    round-robin to partitions (reference: MpiBranchAndBound.cpp:127-144).
    Returns partition index per node."""
    order = np.argsort(lbs, kind="stable")
    part = np.empty(len(lbs), dtype=np.int32)
    part[order] = np.arange(len(lbs)) % n_parts
    return part
