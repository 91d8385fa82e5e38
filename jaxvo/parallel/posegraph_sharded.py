"""Edge-sharded distributed pose-graph optimization.

The multi-host half of BASELINE.json config 5 ("multi-host sharded
pose-graph + Schur-complement BA"): edges are partitioned across devices,
each device linearizes its own edge shard into the full (F, F) block
system, and ONE ``psum`` per iteration combines [H | b | chi] — the same
single-fused-collective discipline as the sharded Schur BA
(jaxvo/parallel/ba_sharded.py).  Poses are replicated (F is the small
axis); every device solves the same damped system and applies the same
update, so no broadcast is needed afterwards.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from jax import shard_map

from jaxvo.ba.posegraph import (
    PGOStats,
    PoseGraph,
    _solve_system,
    linearize_pgo,
    pgo_eval_chi,
)
from jaxvo.ops import lie


def shard_edges(graph: PoseGraph, n_shards: int) -> PoseGraph:
    """Pad the edge set to a multiple of n_shards (weight-0 edges are inert)."""
    E = graph.edges_ij.shape[0]
    Ep = -(-E // n_shards) * n_shards
    pad = Ep - E
    if pad == 0:
        return graph
    eij = jnp.concatenate(
        [graph.edges_ij, jnp.zeros((pad, 2), jnp.int32)], 0)
    eT = jnp.concatenate(
        [graph.edges_T,
         jnp.broadcast_to(jnp.eye(4, dtype=graph.edges_T.dtype), (pad, 4, 4))], 0)
    ew = jnp.concatenate([graph.edges_w, jnp.zeros(pad, jnp.float32)], 0)
    return graph._replace(edges_ij=eij, edges_T=eT, edges_w=ew)


def sharded_pgo_solve(mesh, graph: PoseGraph, iterations: int = 20,
                      kernel_threshold: float = 1.0, damping: float = 1e-6,
                      damping_init: float = 1e-3, axis: str = "edge"):
    """Distributed adaptive-LM PGO: edge shards + one fused psum/iteration
    (plus one scalar psum for the trust-region acceptance test)."""
    n = mesh.shape[axis]
    graph = shard_edges(graph, n)
    F = graph.poses.shape[0]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def solve(poses, edges_ij, edges_T, edges_w, fixed):
        local = lambda ps: PoseGraph(ps, edges_ij, edges_T, edges_w, fixed)

        def chi_of(ps):
            return jax.lax.psum(
                pgo_eval_chi(ps, local(ps), kernel_threshold), axis)

        def body(_, carry):
            poses, lam_lm, chi_prev, n_inl = carry
            H, b, chi_lin, n_i = linearize_pgo(local(poses), kernel_threshold)
            # THE collective: [H | b | n_inliers] in one fused psum buffer
            Hf = H.transpose(0, 2, 1, 3).reshape(F * 6, F * 6)
            buf = jnp.concatenate(
                [Hf, b.reshape(F * 6)[:, None],
                 jnp.concatenate([n_i.astype(jnp.float32)[None],
                                  jnp.zeros(F * 6 - 1, jnp.float32)])[:, None]],
                axis=1,
            )
            buf = jax.lax.psum(buf, axis)
            Hs = buf[:, : F * 6].reshape(F, 6, F, 6).transpose(0, 2, 1, 3)
            bs = buf[:, F * 6].reshape(F, 6)
            n_tot = buf[0, F * 6 + 1].astype(jnp.int32)

            dx = _solve_system(Hs, bs, fixed, lam_lm)
            new_poses = jax.vmap(lambda d, T: lie.se3_exp(d) @ T)(dx, poses)
            new_poses = jnp.where(fixed[:, None, None], poses, new_poses)
            chi_new = chi_of(new_poses)
            accept = (
                jnp.isfinite(chi_new)
                & jnp.all(jnp.isfinite(new_poses))
                & (chi_new <= chi_prev)
            )
            poses = jnp.where(accept, new_poses, poses)
            lam_lm = jnp.where(
                accept,
                jnp.maximum(lam_lm * 0.5, damping),
                jnp.minimum(lam_lm * 4.0, 1e8),
            )
            chi_prev = jnp.where(accept, chi_new, chi_prev)
            return poses, lam_lm, chi_prev, n_tot

        chi0 = chi_of(poses)
        poses, _, chi, n_inl = jax.lax.fori_loop(
            0, iterations, body,
            (poses, jnp.float32(damping_init), chi0, jnp.int32(0)),
        )
        return poses, PGOStats(chi, n_inl, jnp.int32(iterations))

    poses, stats = solve(
        graph.poses, graph.edges_ij, graph.edges_T, graph.edges_w, graph.fixed)
    return graph._replace(poses=poses), stats
