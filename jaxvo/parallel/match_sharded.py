"""Landmark-sharded descriptor matching (SURVEY.md §5 "long-context" row).

The map axis is the engine's sequence axis: for maps too large for one
device (or to ride multi-chip bandwidth), each device scans its landmark
shard for the local (best, idx, second) triple; an ``all_gather`` of the
tiny per-row triples (not the distance matrix!) then reduces to the exact
global top-2.  Communication is O(N · devices), independent of map size.

Correctness of the merge: the global best is the min over shard bests
(first shard wins ties, preserving the reference's first-index rule since
shards partition the map in order); the global second-best is the min of
the remaining candidates — which is exactly min(second of the winning
shard, best of every other shard).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from jaxvo.ops.match import MatchResult, descriptor_distances, top2_min


def _local_top2(desc1, desc2_shard, valid2_shard, method):
    dist = descriptor_distances(desc1, desc2_shard, method)
    best, idx, second = top2_min(dist, valid2_shard)
    return best, idx, second


def sharded_match_descriptors(
    mesh,
    desc1,
    valid1,
    desc2,
    valid2,
    distance_threshold: float = 0.2,
    ratio_threshold: float = 0.8,
    method: str = "direct",
    axis: str = "lm",
) -> MatchResult:
    """Exact equivalent of ops.match.match_descriptors with the map axis
    sharded across ``mesh``.  desc2/valid2 must have a leading dimension
    divisible by the mesh axis size."""
    M = desc2.shape[0]
    n_shard = mesh.shape[axis]
    shard_size = M // n_shard
    assert shard_size * n_shard == M, "map size must divide the mesh axis"
    # indices ride the fused f32 all_gather buffer — exact below 2^24
    assert M < 2**24, "fused gather carries indices in f32"

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def matcher(d1, v1, d2s, v2s):
        best, idx, second = _local_top2(d1, d2s, v2s, method)
        shard_id = jax.lax.axis_index(axis)
        idx_global = idx + shard_id * shard_size
        # ONE fused all_gather of the per-row triples (collectives are
        # latency-bound: one (3, N) message beats three (N,) messages)
        triple = jnp.stack(
            [best, idx_global.astype(jnp.float32), second]
        )  # (3, N)
        gathered = jax.lax.all_gather(triple, axis)  # (S, 3, N)
        bests = gathered[:, 0]                       # (S, N)
        idxs = gathered[:, 1].astype(jnp.int32)      # (S, N)
        seconds = gathered[:, 2]                     # (S, N)
        win = jnp.argmin(bests, axis=0)              # first shard wins ties
        n = best.shape[0]
        rows = jnp.arange(n)
        g_best = bests[win, rows]
        g_idx = idxs[win, rows]
        # runner-up = min over (winner's second, other shards' bests)
        masked_bests = jnp.where(
            jnp.arange(n_shard)[:, None] == win[None, :], jnp.inf, bests
        )
        g_second = jnp.minimum(seconds[win, rows], jnp.min(masked_bests, axis=0))
        return g_best, g_idx, g_second

    best, idx, second = matcher(desc1, valid1, desc2, valid2)
    ratio = best / second
    accept = (best < distance_threshold) & (ratio < ratio_threshold) & valid1
    return MatchResult(idx=idx.astype(jnp.int32), valid=accept, best=best, second=second)
