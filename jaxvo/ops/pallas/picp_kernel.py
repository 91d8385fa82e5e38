"""Fused PICP solver: the whole Gauss-Newton loop in one Pallas kernel,
lowered through Triton for NVIDIA GPUs.

Why: the XLA solver (ops/picp.py) is a data-dependent ``lax.while_loop``
nested in the frame scan.  Each GN round is ~40 tiny fused kernels, and
the loop predicate is read back by the host before every round.  Here the
full loop (projection, analytic Jacobians, saturating-kernel weights,
H/b reductions, unrolled 6x6 Cholesky, Euler retraction, the icp_test
stopping rule) runs inside one kernel launch, with the predicate on the
device.

Math is the formulas of picp_solver.cpp:26-105 (see ops/picp.py for the
line-by-line mapping); this file is the performance twin, validated
against the XLA path in tests/test_pallas_picp.py.

Layout: one program per solve.  The N observations sit in one block as
six (N,) vectors (x, y, z of the world point, u, v of the measurement,
validity), N padded to a power of two as Triton requires.  The pose goes
in and out as a row-major (16,) vector and the statistics as (8,).  Under
``jax.vmap`` the batch becomes the grid: one program per lane.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from jaxvo.config import PICPConfig
from jaxvo.ops.picp import PICPResult

# One warp per solve: the 128-wide reductions stay inside the warp
# (shuffles, no shared-memory round trip), and a batch of solves fills
# the SMs with one program each.
NUM_WARPS = 1


def _cholesky6_scalar(H, g):
    """Unrolled 6x6 SPD solve on in-kernel scalars. H: list-of-lists, g: list."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        Ljj = jnp.sqrt(jnp.maximum(s, 1e-30))
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, n):
            s = H[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _make_kernel(fx, fy, cx, cy, width, height, cfg: PICPConfig):
    thr = cfg.kernel_threshold
    damping = cfg.damping
    conv = cfg.convergence_threshold
    max_it = cfg.max_iterations
    min_inl = cfg.min_num_inliers
    keep_outliers = cfg.keep_outliers

    def kernel(x0_ref, x1_ref, x2_ref, zu_ref, zv_ref, valid_ref, t0_ref,
               t_out_ref, stats_ref):
        X0 = x0_ref[...]  # (N,)
        X1 = x1_ref[...]
        X2 = x2_ref[...]
        zu = zu_ref[...]
        zv = zv_ref[...]
        vmask = valid_ref[...]  # (N,) float32 0/1

        # pose entries as scalars: select-and-sum picks entry k of the
        # (16,) vector without a scalar load
        t0 = t0_ref[...]
        lane16 = jax.lax.broadcasted_iota(jnp.int32, (16,), 0)
        pose0 = tuple(jnp.sum(jnp.where(lane16 == k, t0, 0.0))
                      for k in range(12))

        def iterate(carry):
            (R00, R01, R02, t0, R10, R11, R12, t1, R20, R21, R22, t2,
             prev, it, done, n_in, chi_in, chi_out, convd) = carry

            px = R00 * X0 + R01 * X1 + R02 * X2 + t0  # (N,)
            py = R10 * X0 + R11 * X1 + R12 * X2 + t1
            pz = R20 * X0 + R21 * X1 + R22 * X2 + t2

            hx = fx * px + cx * pz
            hy = fy * py + cy * pz
            iz = 1.0 / jnp.where(jnp.abs(pz) > 1e-12, pz, 1.0)
            u = hx * iz
            v = hy * iz
            okb = (
                (vmask > 0.5)
                & (pz > 0.0)
                & (u >= 0.0) & (u <= width - 1.0)
                & (v >= 0.0) & (v <= height - 1.0)
            )
            ok = okb.astype(jnp.float32)

            eu = jnp.where(okb, u - zu, 0.0)
            ev = jnp.where(okb, v - zv, 0.0)
            chi = eu * eu + ev * ev
            inlb = (chi <= thr) & okb
            inl = inlb.astype(jnp.float32)
            lam = jnp.where(chi <= thr, 1.0, jnp.sqrt(thr / jnp.maximum(chi, 1e-20)))
            contrib = ok if keep_outliers else inl
            w = lam * contrib

            # J = Jp·K·Jr with Jr = [I | skew(-p_cam)] (picp_solver.cpp:37-53)
            # C = Jp·K rows: [fx/z, 0, (cx-u)/z] and [0, fy/z, (cy-v)/z].
            # The (cx, cy) terms are NOT optional: du/dpz = (cx·z - hx)/z²;
            # dropping them is a systematically wrong descent direction
            # that still passes run-to-convergence parity tests (at a
            # residual-zero fixed point the J error cancels in J^T·e = 0)
            # while tripling the GN iterations per solve.
            a = fx * iz
            b = fy * iz
            c = (cx - u) * iz
            d = (cy - v) * iz
            zero = jnp.zeros_like(a)
            J0 = [a, zero, c, c * py, a * pz - c * px, -a * py]
            J1 = [zero, b, d, -b * pz + d * py, -d * px, b * px]
            # where-mask culled rows: their entries can overflow to inf and
            # inf * 0-weight = NaN would poison the reductions
            J0 = [jnp.where(okb, j, 0.0) for j in J0]
            J1 = [jnp.where(okb, j, 0.0) for j in J1]

            H = [[None] * 6 for _ in range(6)]
            g = [None] * 6
            for i in range(6):
                for j in range(i, 6):
                    H[i][j] = jnp.sum((J0[i] * J0[j] + J1[i] * J1[j]) * w)
                    H[j][i] = H[i][j]
                g[i] = jnp.sum((J0[i] * eu + J1[i] * ev) * w)
            for i in range(6):
                H[i][i] = H[i][i] + damping

            num_inl = jnp.sum(inl).astype(jnp.int32)
            chi_in_s = jnp.sum(chi * inl)
            chi_out_s = jnp.sum(chi * ok * (1.0 - inl))
            okflag = num_inl >= min_inl

            dx = _cholesky6_scalar(H, [-gi for gi in g])
            # T <- v2tEuler(dx) · T  (defs.h:131-136: R = Rx·Ry·Rz)
            cxr, sxr = jnp.cos(dx[3]), jnp.sin(dx[3])
            cyr, syr = jnp.cos(dx[4]), jnp.sin(dx[4])
            czr, szr = jnp.cos(dx[5]), jnp.sin(dx[5])
            D00 = cyr * czr
            D01 = -cyr * szr
            D02 = syr
            D10 = sxr * syr * czr + cxr * szr
            D11 = -sxr * syr * szr + cxr * czr
            D12 = -sxr * cyr
            D20 = -cxr * syr * czr + sxr * szr
            D21 = cxr * syr * szr + sxr * czr
            D22 = cxr * cyr

            def row(Da, Db, Dc, add):
                return (
                    Da * R00 + Db * R10 + Dc * R20,
                    Da * R01 + Db * R11 + Dc * R21,
                    Da * R02 + Db * R12 + Dc * R22,
                    Da * t0 + Db * t1 + Dc * t2 + add,
                )

            n0 = row(D00, D01, D02, dx[0])
            n1 = row(D10, D11, D12, dx[1])
            n2 = row(D20, D21, D22, dx[2])
            sel = lambda new, old: jnp.where(okflag, new, old)
            out_pose = (
                sel(n0[0], R00), sel(n0[1], R01), sel(n0[2], R02), sel(n0[3], t0),
                sel(n1[0], R10), sel(n1[1], R11), sel(n1[2], R12), sel(n1[3], t1),
                sel(n2[0], R20), sel(n2[1], R21), sel(n2[2], R22), sel(n2[3], t2),
            )

            curr = chi_in_s
            rel = jnp.where(prev > 1e-10, jnp.abs(prev - curr) / prev, 0.0)
            convd2 = okflag & (rel < conv)
            done2 = (~okflag) | convd2
            return out_pose + (curr, it + 1, done2, num_inl, chi_in_s, chi_out_s, convd2)

        def cond(carry):
            it = carry[13]
            done = carry[14]
            return (~done) & (it < max_it)

        init = pose0 + (
            np.float32(1e30),  # PREV_CHI_INIT (see ops/picp.py)
            jnp.int32(0), jnp.bool_(False),
            jnp.int32(0), jnp.float32(0.0), jnp.float32(0.0), jnp.bool_(False),
        )
        final = jax.lax.while_loop(cond, iterate, init)
        pose = final[:12]
        _prev, it, _done, n_in, chi_in, chi_out, convd = final[12:]

        # scalars back into vectors by the same select-and-sum
        vals = pose + (0.0, 0.0, 0.0, 1.0)
        t_out_ref[...] = sum(jnp.where(lane16 == k, val, 0.0)
                             for k, val in enumerate(vals))
        lane8 = jax.lax.broadcasted_iota(jnp.int32, (8,), 0)
        stats = (n_in.astype(jnp.float32), chi_in, chi_out,
                 it.astype(jnp.float32), convd.astype(jnp.float32))
        stats_ref[...] = sum(jnp.where(lane8 == k, val, 0.0)
                             for k, val in enumerate(stats))

    return kernel


@functools.partial(
    jax.jit, static_argnames=("fx", "fy", "cx", "cy", "width", "height", "cfg", "interpret")
)
def _solve_pallas_impl(T_init, X, image_uv, corr_valid,
                       fx, fy, cx, cy, width, height, cfg, interpret):
    n = X.shape[0]
    n_pad = max(16, 1 << (n - 1).bit_length())  # Triton blocks: powers of 2
    pad = lambda a: jnp.pad(a.astype(jnp.float32), (0, n_pad - n))
    obs = [pad(X[:, 0]), pad(X[:, 1]), pad(X[:, 2]),
           pad(image_uv[:, 0]), pad(image_uv[:, 1]), pad(corr_valid)]
    kernel = _make_kernel(fx, fy, cx, cy, width, height, cfg)
    T, stats = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((16,), jnp.float32),
            jax.ShapeDtypeStruct((8,), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="picp_gn_loop",
    )(*obs, T_init.astype(jnp.float32).reshape(16))
    return PICPResult(
        T=T.reshape(4, 4),
        num_inliers=stats[0].astype(jnp.int32),
        chi_inliers=stats[1],
        chi_outliers=stats[2],
        iterations=stats[3].astype(jnp.int32),
        converged=stats[4] > 0.5,
    )


@jax.named_scope("picp")
def solve_pallas(K, T_init, world_pts, image_uv, corr_idx, corr_valid,
                 width: int, height: int, cfg: PICPConfig,
                 interpret: bool = False) -> PICPResult:
    """Drop-in replacement for ops.picp.solve with the fused kernel.

    K must be a concrete (host) intrinsics matrix — its entries are baked
    into the kernel as constants.  corr_idx indexes world_pts per
    observation (gathered once, outside the kernel); pass corr_idx=None if
    world_pts is already per-observation.  ``interpret=True`` runs the
    kernel through the Pallas interpreter (CPU tests).
    """
    Kh = np.asarray(K)
    X = world_pts if corr_idx is None else world_pts[corr_idx]
    return _solve_pallas_impl(
        T_init, X, image_uv, corr_valid,
        float(Kh[0, 0]), float(Kh[1, 1]), float(Kh[0, 2]), float(Kh[1, 2]),
        float(width), float(height), cfg, interpret,
    )
