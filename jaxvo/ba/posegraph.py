"""Pose-graph optimization: Gauss-Newton on SE(3) over relative-pose edges.

NEW layer with no reference counterpart (BASELINE.json config 5 is
"multi-host sharded pose-graph + Schur-complement BA"; ba/window.py is the
Schur half, this is the pose-graph half).  The reference tracks frame to
frame and never revisits poses (exec/icp_test.cpp:61-136).

Formulation — classic PGO:
  * state: F camera-in-world poses T_i (4x4)
  * edge (i, j) with measured relative pose Z_ij and weight w:
        r_ij = log_se3( Z_ij^-1 · (T_i^-1 · T_j) )   in R^6
  * GN over left-multiplicative perturbations T_k <- exp(xi_k)·T_k;
    the 6x6 edge Jacobian blocks come from ``jax.jacfwd`` of the residual
    — exact, no hand-derived adjoint approximations
  * gauge: pose 0 fixed (plus any extra ``fixed`` mask entries)
  * robust kernel: the same saturating sqrt(thr/chi) weight as PICP
    (picp_solver.cpp:74-84), applied per edge on chi = r^T·r

Accelerator-first: all edges linearize in one vmapped pass; H is assembled with
segment-sums over the edge axis into (F, F) 6x6 blocks (F is small — the
frame axis); the solve is one damped Cholesky on the (6F, 6F) system.  The
edge axis is the sharding axis: ``jaxvo/parallel/posegraph_sharded.py``
gives each device an edge shard and psums the reduced system — identical
collective pattern to the sharded Schur BA.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from jaxvo.ops import lie


class PoseGraph(NamedTuple):
    """Fixed-shape pose-graph problem.

    poses:      (F, 4, 4) camera-in-world estimates (optimized in place)
    edges_ij:   (E, 2) int32 node indices (i, j)
    edges_T:    (E, 4, 4) measured relative poses Z_ij = T_i^-1 T_j
    edges_w:    (E,) float32 edge weights (0 disables an edge — padding)
    fixed:      (F,) bool — poses held fixed (gauge; pose 0 at minimum)
    """

    poses: jnp.ndarray
    edges_ij: jnp.ndarray
    edges_T: jnp.ndarray
    edges_w: jnp.ndarray
    fixed: jnp.ndarray


class PGOStats(NamedTuple):
    chi: jnp.ndarray         # robust total chi (sum min(r^T r, thr))
    num_inliers: jnp.ndarray
    iterations: jnp.ndarray


def edge_residual(T_i, T_j, Z_ij):
    """r = log_se3(Z^-1 · T_i^-1 · T_j) — zero iff the edge is satisfied."""
    return lie.se3_log(lie.inv_se3(Z_ij) @ lie.inv_se3(T_i) @ T_j)


def _edge_lin(T_i, T_j, Z_ij):
    """Residual + exact 6x6 Jacobians wrt left perturbations of T_i, T_j."""

    def f(xi):
        xi_i, xi_j = xi[:6], xi[6:]
        return edge_residual(
            lie.se3_exp(xi_i) @ T_i, lie.se3_exp(xi_j) @ T_j, Z_ij
        )

    r = edge_residual(T_i, T_j, Z_ij)
    J = jax.jacfwd(f)(jnp.zeros(12, T_i.dtype))  # (6, 12)
    return r, J[:, :6], J[:, 6:]


def linearize_pgo(graph: PoseGraph, kernel_threshold: float):
    """All-edge linearization -> (H (F,F,6,6), b (F,6), stats pieces).

    The per-edge blocks are scattered into the block matrix with
    segment-sums over flattened (i·F+j) indices — the same fixed-shape
    pattern as the BA coupling blocks (ba/window.py:linearize_ba).
    """
    F = graph.poses.shape[0]
    ii = graph.edges_ij[:, 0]
    jj = graph.edges_ij[:, 1]

    r, Ji, Jj = jax.vmap(_edge_lin)(
        graph.poses[ii], graph.poses[jj], graph.edges_T
    )  # (E, 6), (E, 6, 6), (E, 6, 6)

    chi = jnp.sum(r * r, -1)
    active = graph.edges_w > 0
    lam = jnp.where(
        chi <= kernel_threshold, 1.0,
        jnp.sqrt(kernel_threshold / jnp.maximum(chi, 1e-20)),
    )
    w = graph.edges_w * lam * active

    # per-edge normal-equation blocks
    Hii = jnp.einsum("eki,ekj,e->eij", Ji, Ji, w)
    Hjj = jnp.einsum("eki,ekj,e->eij", Jj, Jj, w)
    Hij = jnp.einsum("eki,ekj,e->eij", Ji, Jj, w)
    bi = jnp.einsum("eki,ek,e->ei", Ji, r, w)
    bj = jnp.einsum("eki,ek,e->ei", Jj, r, w)

    seg = lambda blocks, idx, n: jax.ops.segment_sum(blocks, idx, num_segments=n)
    H = (
        seg(Hii, ii * F + ii, F * F)
        + seg(Hjj, jj * F + jj, F * F)
        + seg(Hij, ii * F + jj, F * F)
        + seg(jnp.swapaxes(Hij, -1, -2), jj * F + ii, F * F)
    ).reshape(F, F, 6, 6)
    b = seg(bi, ii, F) + seg(bj, jj, F)

    chi_rob = jnp.sum(jnp.where(active, jnp.minimum(chi, kernel_threshold), 0.0))
    n_inl = jnp.sum(active & (chi <= kernel_threshold))
    return H, b, chi_rob, n_inl


def _solve_system(H, b, fixed, damping):
    """Damped gauge-fixed solve of the (6F, 6F) block system."""
    F = H.shape[0]
    S = jnp.transpose(H, (0, 2, 1, 3)).reshape(F * 6, F * 6)
    free = jnp.repeat(~fixed, 6).astype(S.dtype)
    S = S * free[:, None] * free[None, :]
    eye = jnp.eye(F * 6, dtype=S.dtype)
    S = S + eye * (damping * free + (1.0 - free))
    rhs = -b.reshape(F * 6) * free
    c, low = jax.scipy.linalg.cho_factor(S)
    dx = jax.scipy.linalg.cho_solve((c, low), rhs)
    return dx.reshape(F, 6)


def pgo_eval_chi(poses, graph: PoseGraph, kernel_threshold: float):
    """Truncated robust objective at given poses (LM accept/reject)."""
    ii = graph.edges_ij[:, 0]
    jj = graph.edges_ij[:, 1]
    r = jax.vmap(edge_residual)(poses[ii], poses[jj], graph.edges_T)
    chi = jnp.sum(r * r, -1)
    active = graph.edges_w > 0
    return jnp.sum(
        jnp.where(active, graph.edges_w * jnp.minimum(chi, kernel_threshold), 0.0)
    )


@partial(jax.jit, static_argnames=("iterations",))
def pgo_solve(graph: PoseGraph, iterations: int = 20,
              kernel_threshold: float = 1.0, damping: float = 1e-6,
              damping_init: float = 1e-3):
    """Adaptive-LM pose-graph solve, one compiled program.

    Same trust-region schedule as ba_solve: one trial step per iteration,
    rejected/non-finite steps roll back with lambda x4, accepted relax
    x0.5 toward ``damping``.  Returns (optimized PoseGraph, PGOStats).
    """

    def body(_, carry):
        poses, lam_lm, chi_prev, n_inl = carry
        g = graph._replace(poses=poses)
        H, b, chi_lin, n = linearize_pgo(g, kernel_threshold)
        dx = _solve_system(H, b, graph.fixed, lam_lm)
        new_poses = jax.vmap(lambda d, T: lie.se3_exp(d) @ T)(dx, poses)
        new_poses = jnp.where(graph.fixed[:, None, None], poses, new_poses)
        chi_new = pgo_eval_chi(new_poses, graph, kernel_threshold)
        accept = jnp.isfinite(chi_new) & jnp.all(jnp.isfinite(new_poses)) & (
            chi_new <= chi_prev
        )
        poses = jnp.where(accept, new_poses, poses)
        lam_lm = jnp.where(
            accept,
            jnp.maximum(lam_lm * 0.5, damping),
            jnp.minimum(lam_lm * 4.0, 1e8),
        )
        chi_prev = jnp.where(accept, chi_new, chi_prev)
        return poses, lam_lm, chi_prev, n

    chi0 = pgo_eval_chi(graph.poses, graph, kernel_threshold)
    poses, _, chi, n_inl = jax.lax.fori_loop(
        0, iterations, body,
        (graph.poses, jnp.float32(damping_init), chi0, jnp.int32(0)),
    )
    return graph._replace(poses=poses), PGOStats(chi, n_inl, jnp.int32(iterations))


# ---------------------------------------------------------------------------
# Graph construction from a VO run
# ---------------------------------------------------------------------------
def odometry_edges(poses, weight: float = 1.0):
    """Sequential (i, i+1) edges from a tracked trajectory.

    poses: (F, 4, 4) camera-in-world.  Returns (edges_ij, edges_T, edges_w).
    """
    F = poses.shape[0]
    ii = jnp.arange(F - 1, dtype=jnp.int32)
    edges_ij = jnp.stack([ii, ii + 1], -1)
    Ti = poses[:-1]
    Tj = poses[1:]
    edges_T = jax.vmap(lambda a, b: lie.inv_se3(a) @ b)(Ti, Tj)
    edges_w = jnp.full((F - 1,), weight, jnp.float32)
    return edges_ij, edges_T, edges_w


def window_edges(poses_refined, window: int, step: int, weight: float = 1.0,
                 skip: int = 2):
    """Relative-pose constraints harvested from windowed-BA output.

    For each window [lo, lo+W) of the refined trajectory, emit edges
    (lo, lo+k) for k in [skip, W): the window-LOCAL relative poses are
    accurate even though the window's absolute anchor has drifted — the
    pose graph fuses the overlapping local estimates into one globally
    consistent trajectory (hierarchical SLAM: local BA + global PGO).
    """
    F = poses_refined.shape[0]
    eij, eT, ew = [], [], []
    inv = lie.inv_se3
    for lo in range(0, F - window + 1, step):
        for k in range(skip, window):
            i, j = lo, lo + k
            eij.append((i, j))
            eT.append(inv(poses_refined[i]) @ poses_refined[j])
            ew.append(weight)
    return (
        jnp.asarray(eij, jnp.int32),
        jnp.stack(eT),
        jnp.asarray(ew, jnp.float32),
    )


def build_graph(poses, extra_edges=None, odo_weight: float = 1.0) -> PoseGraph:
    """Odometry backbone + optional extra (e.g. loop-closure) edge sets.

    extra_edges: list of (edges_ij, edges_T, edges_w) triples.
    """
    poses = jnp.asarray(poses, jnp.float32)
    F = poses.shape[0]
    sets = [odometry_edges(poses, odo_weight)]
    if extra_edges:
        sets.extend(extra_edges)
    edges_ij = jnp.concatenate([s[0] for s in sets], 0)
    edges_T = jnp.concatenate([s[1] for s in sets], 0)
    edges_w = jnp.concatenate([s[2] for s in sets], 0)
    fixed = jnp.zeros(F, bool).at[0].set(True)
    return PoseGraph(poses, edges_ij, edges_T, edges_w, fixed)
