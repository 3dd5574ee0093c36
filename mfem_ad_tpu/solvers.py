"""Solvers: matrix-free Krylov methods + Newton, and a dense direct path.

The reference leans on sparse direct solvers (UMFPackSolver ex1.cpp:65,
MUMPSMonoSolver ex4.cpp:166) inside MFEM's NewtonSolver.  This package
has no sparse direct factorization, so the load-bearing substitution is:

- matrix-free preconditioned CG / MINRES / GMRES over the partial-assembly
  Jacobian action (forms.grad_mult) — the scalable path;
- a dense LU (``jnp.linalg.solve``) on the assembled global matrix — exact
  like a direct solver, appropriate for the example-sized problems and for
  verifying the iterative path.

``newton`` reproduces MFEM NewtonSolver semantics (ex2.cpp:79-89,
ex4.cpp:167-175): solve J c = r with r = Mult(x) - b, update x <- x - c,
converge on ||r|| <= max(rel_tol*||r0||, abs_tol).
"""

from __future__ import annotations

import os as _os
import time as _time
from dataclasses import dataclass, field
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .utils import profiling


def _device_bytes_limit() -> float:
    """Memory the default device's allocator may hand out, in bytes: the
    allocator's own limit on an accelerator, physical memory on the
    CPU backend (which keeps no memory statistics)."""
    stats = jax.devices()[0].memory_stats()
    if stats and "bytes_limit" in stats:
        return float(stats["bytes_limit"])
    return float(_os.sysconf("SC_PAGE_SIZE") * _os.sysconf("SC_PHYS_PAGES"))


# ---------------------------------------------------------------------------
# Krylov methods (jittable, matvec closures)
# ---------------------------------------------------------------------------


def _pcg_kernel(matvec, M, target2, window: int):
    """The guarded-PCG loop body/cond shared by ``cg`` and the chunked
    Schur driver.  Carry: (x, r, p, gamma, k, best, mark, stall, kend).

    Floor exit: a tight tol (1e-13) can sit just below the attainable
    residual, and without this the while_loop spins
    to maxiter on EVERY solve.  Criterion: every `window` iterations, require
    at least 1% cumulative reduction of the best residual over the
    window, else stop.  (A short no-improvement counter is NOT safe:
    PCG residuals plateau for long stretches on ill-conditioned LVPP
    Schur systems while still converging — a 60-iteration/0.1% version
    of this exit broke ex4's Newton at alpha >= 1.6.)
    """

    def body(carry):
        x, r, p, gamma, k, best, mark, stall, kend = carry
        Ap = matvec(p)
        denom = jnp.vdot(p, Ap)
        alpha = jnp.where(denom != 0, gamma / jnp.where(denom == 0, 1.0, denom), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = jnp.vdot(r, z)
        beta = jnp.where(gamma != 0, gamma_new / jnp.where(gamma == 0, 1.0, gamma), 0.0)
        p = z + beta * p
        best = jnp.minimum(best, jnp.vdot(r, r))
        at_window = (k + 1) % window == 0
        stall = jnp.logical_and(at_window, best > mark * (1.0 - 1e-2))
        mark = jnp.where(at_window, best, mark)
        return x, r, p, gamma_new, k + 1, best, mark, stall, kend

    def cond(carry):
        _, r, _, gamma, k, _, _, stall, kend = carry
        rs = jnp.vdot(r, r)
        ok = jnp.logical_and(k < kend, rs > target2)
        ok = jnp.logical_and(ok, gamma != 0)
        return jnp.logical_and(ok, jnp.logical_not(stall))

    return body, cond


def _pcg_init(matvec, M, bn, x0n, kend):
    """Initial PCG carry for the normalized system."""
    r0 = bn - matvec(x0n)
    z0 = M(r0)
    gamma0 = jnp.vdot(r0, z0)
    rs0 = jnp.vdot(r0, r0)
    return (x0n, r0, z0, gamma0, jnp.asarray(0, jnp.int32), rs0, rs0,
            jnp.asarray(False), jnp.asarray(kend, jnp.int32))


def cg(matvec, b, x0=None, M=None, tol=1e-10, atol=0.0, maxiter=1000,
       stall_window=200):
    """Preconditioned CG with division guards and a normalized RHS.

    Not jax.scipy's: the squared residual norms of a nearly-converged
    solve can underflow to zero (f32 always, f64 at exact x0), and
    jax.scipy's unguarded gamma/denom becomes 0/0 = NaN.  Here every
    division is guarded (a zero denominator terminates progress instead of
    poisoning the iterate) and the system is solved for b/||b|| so the
    monitored quantities stay O(1).  See ``_pcg_kernel`` for the
    windowed floor exit; ``stall_window`` sets the window (iterations per
    >=1% required reduction) and ``stall_window=None`` disables the exit
    for callers that need strict run-to-tolerance semantics.
    """
    norm_b = jnp.linalg.norm(b)
    bsafe = jnp.where(norm_b == 0, 1.0, norm_b)
    bn = b / bsafe
    if M is None:
        M = lambda v: v  # noqa: E731
    x0n = jnp.zeros_like(b) if x0 is None else x0 / bsafe

    target2 = jnp.maximum(tol, atol / bsafe) ** 2  # vs ||r||/||b||
    window = maxiter + 1 if stall_window is None else min(stall_window, maxiter)
    body, cond = _pcg_kernel(matvec, M, target2, window)
    out = jax.lax.while_loop(
        cond, body, _pcg_init(matvec, M, bn, x0n, maxiter)
    )
    return out[0] * bsafe


def gmres(matvec, b, x0=None, M=None, tol=1e-10, atol=0.0, maxiter=1000,
          restart=50):
    """Restarted GMRES with Givens rotations and guarded divisions.

    Replaces jax.scipy.sparse.linalg.gmres for the same reason cg/minres
    were rewritten: a converged/underflowed residual turns jax.scipy's
    unguarded beta/h divisions into 0/0 = NaN (trivially reproduced with
    an exact x0).  Here every division is guarded (a zero Arnoldi norm is
    a happy breakdown that terminates the cycle), the system is solved
    for b/||b||, and a non-improving restart cycle exits instead of
    spinning to maxiter.  Left-preconditioned: ``M`` approximates A^-1
    and the monitored residual is the preconditioned one (as in MFEM's
    GMRESSolver).  Fully jittable (lax loops, fixed [restart+1, n]
    basis)."""
    dt = b.dtype
    n = b.shape[0]
    norm_b = jnp.linalg.norm(b)
    bscale = jnp.where(norm_b == 0, 1.0, norm_b)
    bn = b / bscale
    if M is None:
        M = lambda v: v  # noqa: E731
    x_init = jnp.zeros_like(b) if x0 is None else x0 / bscale
    target = jnp.maximum(tol, atol / bscale)
    m = int(max(1, min(restart, maxiter)))
    idx1 = jnp.arange(m + 1)

    def cycle(x):
        """One Arnoldi cycle from iterate x; returns (x', res, its)."""
        r0 = M(bn - matvec(x))
        beta = jnp.linalg.norm(r0)
        beta_safe = jnp.where(beta == 0, 1.0, beta)
        V = jnp.zeros((m + 1, n), dt).at[0].set(r0 / beta_safe)
        H = jnp.zeros((m + 1, m), dt)
        cs = jnp.ones(m, dt)
        sn = jnp.zeros(m, dt)
        g = jnp.zeros(m + 1, dt).at[0].set(beta)

        def body(carry):
            V, H, cs, sn, g, j, res, brk = carry
            w = M(matvec(V[j]))
            mask = idx1 <= j
            # CGS2: classical Gram-Schmidt, twice (orthogonality to ~eps)
            h = jnp.where(mask, V @ w, 0.0)
            w = w - h @ V
            h2 = jnp.where(mask, V @ w, 0.0)
            w = w - h2 @ V
            h = h + h2
            hn = jnp.linalg.norm(w)
            hcol = h.at[jnp.minimum(j + 1, m)].set(hn)

            # apply the previous rotations (identity beyond j: cs=1,sn=0)
            def rot(i, hc):
                hi, hi1 = hc[i], hc[i + 1]
                hc = hc.at[i].set(cs[i] * hi + sn[i] * hi1)
                return hc.at[i + 1].set(-sn[i] * hi + cs[i] * hi1)

            hcol = jax.lax.fori_loop(0, m, lambda i, hc: jax.lax.cond(
                i < j, lambda: rot(i, hc), lambda: hc), hcol)
            hj, hj1 = hcol[j], hcol[jnp.minimum(j + 1, m)]
            den = jnp.sqrt(hj * hj + hj1 * hj1)
            dsafe = jnp.where(den == 0, 1.0, den)
            cj = jnp.where(den == 0, 1.0, hj / dsafe)
            sj = jnp.where(den == 0, 0.0, hj1 / dsafe)
            hcol = hcol.at[j].set(den).at[jnp.minimum(j + 1, m)].set(0.0)
            gj = g[j]
            g = g.at[j].set(cj * gj)
            g = g.at[jnp.minimum(j + 1, m)].set(-sj * gj)
            res = jnp.abs(-sj * gj)
            return (
                V.at[jnp.minimum(j + 1, m)].set(
                    jnp.where(hn == 0, 0.0, w / jnp.where(hn == 0, 1.0, hn))
                ),
                H.at[:, j].set(hcol),
                cs.at[j].set(cj), sn.at[j].set(sj), g, j + 1, res,
                hn == 0,
            )

        def cond(carry):
            _, _, _, _, _, j, res, brk = carry
            return jnp.logical_and(
                j < m, jnp.logical_and(res > target, jnp.logical_not(brk))
            )

        V, H, cs, sn, g, jdone, res, _ = jax.lax.while_loop(
            cond, body,
            (V, H, cs, sn, g, jnp.asarray(0, jnp.int32), beta,
             jnp.asarray(False)),
        )

        # back-substitute the jdone x jdone triangular system R y = g
        def bs(t, y):
            i = m - 1 - t
            active = i < jdone
            num = g[i] - jnp.dot(H[i], y)
            dii = H[i, i]
            yi = jnp.where(
                jnp.logical_and(active, dii != 0),
                num / jnp.where(dii == 0, 1.0, dii), 0.0,
            )
            return y.at[i].set(yi)

        y = jax.lax.fori_loop(0, m, bs, jnp.zeros(m, dt))
        return x + y @ V[:m], res, jdone

    def outer_body(carry):
        x, res_prev, total, stop = carry
        x, res, jdone = cycle(x)
        # a cycle that made < 0.1% progress is at its floor
        stop = jnp.logical_or(jdone == 0, res > res_prev * (1.0 - 1e-3))
        return x, res, total + jnp.maximum(jdone, 1), stop

    def outer_cond(carry):
        _, res, total, stop = carry
        return jnp.logical_and(
            jnp.logical_and(res > target, total < maxiter),
            jnp.logical_not(stop),
        )

    out = jax.lax.while_loop(
        outer_cond, outer_body,
        (x_init, jnp.asarray(jnp.inf, dt), jnp.asarray(0, jnp.int32),
         jnp.asarray(False)),
    )
    return out[0] * bscale


def _minres_kernel(matvec, M, target, window: int):
    """Paige–Saunders preconditioned-MINRES loop body/cond shared by
    ``minres`` and the chunked Schur driver.  Carry:
    (x, r1, r2, y, oldb, beta, dbar, epsln, phibar, cs, sn, w, w2, it,
    mark, stall, kend).  Same windowed floor exit as ``_pcg_kernel``
    (phibar is monotone in MINRES, so "best" is just the current phibar;
    require >= 1% reduction per window)."""

    def body(carry):
        (x, r1, r2, y, oldb, beta, dbar, epsln, phibar, cs, sn, w, w2, it,
         mark, stall, kend) = carry
        bsafe = jnp.where(beta == 0, 1.0, beta)
        v = y / bsafe
        yv = matvec(v)
        yv = jnp.where(it > 0, yv - (beta / jnp.where(oldb == 0, 1.0, oldb)) * r1, yv)
        alfa = jnp.vdot(v, yv)
        yv = yv - (alfa / bsafe) * r2
        r1n, r2n = r2, yv
        yn = M(yv)
        oldb_n = beta
        beta_n = jnp.sqrt(jnp.abs(jnp.vdot(r2n, yn)))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n
        gamma = jnp.sqrt(gbar**2 + beta_n**2)
        gamma = jnp.where(gamma == 0, 1e-30, gamma)  # 1e-300 is 0 in f32
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar
        w1, w2n = w2, w
        wn = (v - oldeps * w1 - delta * w2n) / gamma
        xn = x + phi * wn
        at_window = (it + 1) % window == 0
        stall_n = jnp.logical_and(at_window, phibar_n > mark * (1.0 - 1e-2))
        mark_n = jnp.where(at_window, phibar_n, mark)
        return (
            xn, r1n, r2n, yn, oldb_n, beta_n, dbar_n, epsln_n, phibar_n,
            cs_n, sn_n, wn, w2n, it + 1, mark_n, stall_n, kend,
        )

    def cond(carry):
        phibar, it, stall, kend = carry[8], carry[13], carry[15], carry[16]
        ok = jnp.logical_and(it < kend, phibar > target)
        return jnp.logical_and(ok, jnp.logical_not(stall))

    return body, cond


def _minres_init(matvec, M, b, x0, kend):
    """Initial MINRES carry."""
    dt = b.dtype
    r1 = b - matvec(x0)
    y = M(r1)
    beta1 = jnp.sqrt(jnp.abs(jnp.vdot(r1, y)))
    z = jnp.zeros_like(b)
    return (
        x0, r1, r1, y, jnp.asarray(0.0, dt), beta1, jnp.asarray(0.0, dt),
        jnp.asarray(0.0, dt), beta1, jnp.asarray(-1.0, dt),
        jnp.asarray(0.0, dt), z, z, jnp.asarray(0, jnp.int32),
        beta1, jnp.asarray(False), jnp.asarray(kend, jnp.int32),
    )


def minres(matvec, b, x0=None, M=None, tol=1e-10, maxiter=1000,
           stall_window=200):
    """MINRES for symmetric (possibly indefinite) systems — the right Krylov
    method for the LVPP (u, psi) saddle Jacobian (reference solves it with
    MUMPS instead, tools.hpp:128-154).  Optional SPD preconditioner M.
    ``stall_window=None`` disables the windowed floor exit (see ``cg``).
    """
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if M is None:
        M = lambda x: x  # noqa: E731

    target = tol * jnp.maximum(jnp.linalg.norm(b), 1e-30)
    window = maxiter + 1 if stall_window is None else min(stall_window, maxiter)
    body, cond = _minres_kernel(matvec, M, target, window)
    out = jax.lax.while_loop(
        cond, body, _minres_init(matvec, M, b, x0, maxiter)
    )
    return out[0]


_KRYLOV = {"cg": cg, "gmres": gmres, "minres": minres}


# ---------------------------------------------------------------------------
# Schur-complement solver for (u, psi) saddle systems with an L2 latent
# ---------------------------------------------------------------------------


def _batched_inv_small(A):
    """Inverse of a batch of small SPD matrices [e, n, n] via unrolled
    Gauss-Jordan — plain elementwise arithmetic, vectorized over the
    batch, in the Newton path's own dtype.  No pivoting: callers pass SPD
    blocks with a relative diagonal shift already applied.
    """
    n = A.shape[-1]
    if n == 1:
        return 1.0 / A
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    M = jnp.concatenate([A, eye], axis=-1)  # [e, n, 2n]
    for k in range(n):
        row_k = M[:, k, :] / M[:, k, k][:, None]  # [e, 2n]
        M = M - M[:, :, k][:, :, None] * row_k[:, None, :]
        M = M.at[:, k, :].set(row_k)
    return M[..., n:]


def _primal_Mx(fp, pdata, arrays):
    """The S~-block (primal) preconditioner closure from a fused GMG, or
    None.  Returns ``(closure, complete)``: ``complete=True`` means the
    closure IS the primal preconditioner (no additive Jacobi term) — the
    shifted V-cycle on the lumped Schur complement S~ = A + diag(C D~^-1
    C^T) itself, with the alpha-dependent reaction restricted into every
    level (VERDICT r2 #1: the A-only V-cycle over-corrects active-set
    dofs by O(alpha), flooring ex5 at lambda=2.5e-7).  ``complete=False``
    is the legacy additive combination v/diag(S) + V-cycle_A(v)."""
    # Round 3: the shifted V-cycle serves the EXACT-elimination path too
    # (ex4's L2 latent), not just the lumped one — the condensed operator
    # S = A + C D^-1 C^T has the same diffusion+reaction structure, and
    # the additive combination collapses in the mid-alpha active-set
    # transition where the reaction coefficient spans ~10 decades
    # spatially (thousands of CG iterations at alpha=1.6 at ex4/ref-3
    # defaults with the additive M).
    if fp is None or not hasattr(fp, "apply_primal"):
        return None
    if hasattr(fp, "shift_data") and "dshift" in arrays:
        sdata = fp.shift_data(pdata, arrays["dshift"])
        return (lambda v: fp.apply_primal(pdata, v, sdata)), True
    return (lambda v: fp.apply_primal(pdata, v)), False


def _schur_solve_traced(form, tables, ess, state, r, tol: float,
                        maxiter: int, reg: float = 1e-6,
                        jacobi: bool = True, refine: int = 1,
                        lumped: bool = False, fp=None, pdata=()):
    """Traced (jit-safe) Schur reduction of the 2-block LVPP saddle Jacobian
    [[A, C], [C^T, -D]] with an element-block-diagonal latent block D
    (L2 latent: dofs never couple across elements).  Eliminates the latent
    exactly and solves the SPD condensed system with Jacobi-CG.  See
    ``make_pg_schur_solver`` for the math; this variant takes tables/ess as
    traced arguments so solvers can fuse it into a single jitted Newton
    step (no eager per-matvec dispatch).

    The latent block is regularized (see below) so the solve is range-safe
    where the mirror map saturates; ``refine`` steps of iterative
    refinement against the TRUE Jacobian remove the O(reg) direction error
    so Newton keeps its exactness at large alpha.

    ``lumped=True`` handles latent spaces that are NOT element-local (the
    H1^dim latent of ex5.cpp): D is replaced by its diagonal ("lumped
    mass"), the lumped Schur complement S~ = A + C D~^-1 C^T and D~ form
    the classical SPD block-diagonal saddle preconditioner
    blockdiag(S~^-1, D~^-1), and guarded MINRES runs on the TRUE saddle
    Jacobian — unconditionally convergent (MINRES minimizes the residual),
    with iteration counts set by the lumping quality rather than by alpha.
    """
    arrays = _schur_arrays(form, tables, ess, state, reg, jacobi, lumped)
    Mextra = _primal_Mx(fp, pdata, arrays)
    S, M, Dinv, mv, pad_u, pad_p, n0, n1, split = _schur_ops(
        form, tables, ess, state, arrays, lumped, Mextra
    )

    if lumped:
        # SPD block-diagonal preconditioner (lumped Schur + lumped D) for
        # MINRES on the true saddle Jacobian.  With a GMG (Mextra) the
        # S~ block is ONE shifted V-cycle on S~ = A + diag(C D~^-1 C^T)
        # — linear, SPD, and ~40x cheaper per outer iteration than an
        # inner Krylov solve (the reference's PGPreconditioner applies
        # BoomerAMG once the same way, pg.hpp:388-400).  Without one,
        # fall back to a bounded inner CG as the S~-approximation.
        if Mextra is not None:
            Mu = M
            outer = maxiter
        else:
            Mu = lambda rr_u: cg(S, rr_u, M=M, tol=1e-8, maxiter=200)  # noqa: E731
            outer = 200

        def Mblock(rr):
            return jnp.concatenate([Mu(rr[:n0]), Dinv(rr[n0:])])

        return minres(mv, r, M=Mblock, tol=tol, maxiter=outer)

    join = (form.join_u_p if hasattr(form, "join_u_p")
            else lambda a, b: jnp.concatenate([a, b]))

    def solve_reg(rr):
        r_u, r_p = split(rr)
        rhs = r_u + split(mv(pad_p(Dinv(r_p))))[0]
        du = cg(S, rhs, M=M, tol=tol, maxiter=maxiter)
        Ct_du = split(mv(pad_u(du)))[1]
        dp = Dinv(Ct_du - r_p)
        return join(du, dp)

    dx = solve_reg(r)
    for _ in range(refine):
        dx = dx + solve_reg(r - mv(dx))
    return dx


def _schur_arrays(form, tables, ess, state, reg: float, jacobi: bool,
                  lumped: bool):
    """Traced: the array-valued pieces of the Schur reduction (latent-block
    inverse factors + condensed Jacobi diagonal), as a dict that can cross
    jit boundaries — the chunked driver computes them once per Newton
    direction and threads them through every CG-chunk program.  Dispatches
    to ``ShardedForm.schur_arrays_raw`` when the form is element-sharded
    (the element-block ops are shard-local; one psum completes assembly)."""
    if hasattr(form, "schur_arrays_raw"):
        return form.schur_arrays_raw(tables, ess, state, reg, jacobi, lumped)
    d_full = jnp.abs(form.grad_diag_raw(tables, ess, state))
    return _schur_arrays_core(
        form, form.integrators[0], tables[0], ess, state[0], d_full,
        reg, jacobi, lumped,
    )


def _schur_arrays_core(form, intg, t, ess, Hq, d_full, reg: float,
                       jacobi: bool, lumped: bool, psum=None, pmax=None,
                       globalize=None, fast: bool = True, usplit=None):
    """The Schur-reduction array math, shared between the serial path and
    the shard-local body of ``ShardedForm.schur_arrays_raw``.  Collective
    hooks (identity in serial): ``psum`` completes global-dof scatters,
    ``pmax`` global maxima, ``globalize`` re-assembles element-axis arrays
    into their replicated serial layout; ``fast`` is the integrator
    dof-exchange mode for the scatter."""
    ident = lambda x: x  # noqa: E731
    psum = psum or ident
    pmax = pmax or ident
    globalize = globalize or ident
    off = form.offsets
    lb = len(off) - 2
    ub = lb - 1
    n0 = int(off[lb])
    # primal-block slice of a full dof vector: canonical [:n0] by default;
    # the halo (distributed-layout) body passes its local-slot slicer
    usplit = usplit or (lambda v: v[:n0])
    out = {}

    if lumped:
        # NODE-BLOCK lumped latent: assemble the per-node vdim x vdim
        # diagonal blocks of D (valid for any latent space).  Scalar
        # (diagonal) lumping is badly wrong for anisotropic entropies —
        # Hellinger's E*'' = s^2/sqrt(..) (I - s^2 psi psi^T / (1+s^2|psi|^2))
        # goes rank-deficient ALONG psi near saturation, so the node
        # block's eigenvalues differ by the saturation factor; keeping the
        # vdim x vdim coupling captures exactly that anisotropy.
        sp_l = form.spaces[lb]
        vl, ndl = sp_l.vdim, sp_l.nd
        De = -intg.element_matrices(Hq, lb, lb, tables=t)
        ne_l = De.shape[0]
        De4 = De.reshape(ne_l, vl, ndl, vl, ndl)
        node_blocks = jnp.einsum("evdwd->edvw", De4)
        edof_l = t["edof"][lb]  # [ne, ndl] scalar dof ids
        nds_l = sp_l.ndof_scalar
        Dblk = psum(
            jnp.zeros((nds_l, vl, vl), De.dtype).at[edof_l].add(node_blocks)
        )
        tr = jnp.trace(Dblk, axis1=1, axis2=2) / vl
        shift = jnp.maximum(reg * jnp.max(jnp.abs(tr)), 1e-30)
        eye = jnp.eye(vl, dtype=De.dtype)
        Dblk_inv = out["Dblk_inv"] = _batched_inv_small(Dblk + shift * eye)
        # Node-block preconditioner for the DUAL Schur complement
        # Sigma = D + C^T A^-1 C (the latent solve of the FGMRES/LDU
        # direction, _schur_dir_chunked_lumped): per-node vdim x vdim
        # blocks of D + C^T diag(A)^-1 C.  Unlike D~ alone this stays
        # uniformly well-conditioned as the mirror map saturates (D goes
        # rank-deficient along psi; the dual mass term fills the gap).
        sp_u = form.spaces[ub]
        d_A = usplit(d_full)
        inv_dA = jnp.where(
            usplit(ess), 0.0, 1.0 / jnp.where(d_A < 1e-30, 1.0, d_A)
        )
        Ce_ = intg.element_matrices(Hq, ub, lb, tables=t)
        Ce4_ = Ce_.reshape(ne_l, Ce_.shape[1], vl, ndl)
        nds_u = sp_u.ndof_scalar
        edof_u = t["edof"][ub]  # [ne, nd_u] scalar dof ids
        idx_u = (
            edof_u[:, None, :]
            + (jnp.arange(sp_u.vdim) * nds_u)[None, :, None]
        ).reshape(ne_l, -1)  # byNODES rows (v, d) = v*nd + d
        dAe = inv_dA[idx_u]  # [ne, nde_u]
        dual = jnp.einsum("eivd,ei,eiwd->edvw", Ce4_, dAe, Ce4_)
        Sb = Dblk + psum(
            jnp.zeros((nds_l, vl, vl), De.dtype).at[edof_l].add(dual)
        )
        trb = jnp.trace(Sb, axis1=1, axis2=2) / vl
        shiftb = jnp.maximum(1e-12 * jnp.max(jnp.abs(trb)), 1e-30)
        out["Sig_blk_inv"] = _batched_inv_small(Sb + shiftb * eye)
    else:
        De = -intg.element_matrices(Hq, lb, lb, tables=t)  # [ne, ndl, ndl]
        ne, ndl, _ = De.shape
        # E*'' underflows where the mirror map saturates (the active set),
        # making D_e numerically singular; a relative shift keeps the
        # condensed system solvable.  The shift size is load-bearing: near
        # the Newton solution the TRUE step stays O(1e2) even at
        # ||r|| ~ 1e-6 (the system is nearly singular), and a too-small
        # shift amplifies solve noise by 1/(reg*dmax) into a divergent
        # step.  Measured at the ex4/ref-2 failure state vs a dense solve:
        # reg=1e-10 -> relative step error 1.1e+2 (Newton diverges),
        # reg=1e-6 + 1 refinement pass -> 4e-5 (matches dense).  The
        # additional absolute mass-scaled floor guards the fully-flushed
        # case: in f32 (exponent range ~1e+-38) entire blocks can flush
        # to exactly zero and dmax alone would be 0.
        dmax = pmax(jnp.max(jnp.abs(De)))
        eye = jnp.eye(ndl, dtype=De.dtype)
        Bl = t["B"][lb][..., 0]  # [1|ne, nq, ndl] latent VALUE shapes
        wq = t["w"]
        if Bl.shape[0] == 1 and wq.shape[0] != 1:
            # padded sharded tables materialize w per-element while B stays
            # element-shared; align for the einsum
            Bl = jnp.broadcast_to(Bl, (wq.shape[0],) + Bl.shape[1:])
        Me = jnp.einsum("eqd,eqk,eq->edk", Bl, Bl, wq)
        De_inv = _batched_inv_small(De + (reg * dmax) * eye + 1e-20 * Me)
        # globalized (trimmed to the true element count, replicated) for
        # the element-contiguous L2 Dinv application in _schur_ops
        out["De_inv"] = globalize(De_inv)

    if jacobi:
        # diag(S) = diag(A) + diag(C D^{-1} C^T); the second term dominates
        # as alpha grows (D ~ E*''/alpha -> 0 on the active set).
        d = usplit(d_full)
        Ce = intg.element_matrices(Hq, ub, lb, tables=t)  # [ne, nde_u, ndl]
        ne_c = Ce.shape[0]
        sp_u = form.spaces[ub]
        if lumped:
            # diag(C Dblk^-1 C^T) with the node-block inverse: columns of
            # Ce are (w, d) = w*ndl + d byNODES-flat
            sp_l = form.spaces[lb]
            vl, ndl = sp_l.vdim, sp_l.nd
            Ce4 = Ce.reshape(ne_c, Ce.shape[1], vl, ndl)
            be = Dblk_inv[t["edof"][lb]]  # [ne, ndl, vl, vl]
            dS = jnp.einsum("eivd,edvw,eiwd->ei", Ce4, be, Ce4)
        else:
            dS = jnp.einsum("eij,ejk,eik->ei", Ce, De_inv, Ce)
        # byNODES flat rows (v, d) = v*nd + d -> [ne, nd, vdim] for scatter
        dS3 = dS.reshape(ne_c, sp_u.vdim, sp_u.nd).transpose(0, 2, 1)
        dS_nodes = psum(intg.scatter(ub, dS3, t, fast=fast))
        d = d + dS_nodes
        # the raw reaction diagonal diag(C D^-1 C^T) on the primal block,
        # zeroed at essential dofs — input to the shifted GMG (_primal_Mx)
        out["dshift"] = jnp.where(usplit(ess), 0.0, dS_nodes)
        out["safe"] = jnp.where(d < 1e-30, 1.0, d)
    return out


def _schur_ops(form, tables, ess, state, arrays, lumped: bool, Mextra):
    """Rebuild the Schur-reduction closures (condensed operator S, its
    preconditioner M, the latent inverse Dinv, block pad/matvec helpers)
    from the arrays of ``_schur_arrays`` — cheap, callable inside any
    jitted program that receives (state, arrays) as arguments."""
    off = form.offsets
    lb = len(off) - 2
    n0, n1 = int(off[lb]), int(off[lb + 1] - off[lb])
    # distributed-layout (halo) forms provide their own block helpers:
    # vectors are per-shard slot concatenations, so canonical [:n0]
    # slicing does not apply (parallel/halo.py layout)
    halo = hasattr(form, "split_u_p")

    if lumped:
        Dblk_inv = arrays["Dblk_inv"]
        sp_l = form.spaces[lb]
        vl, nds_l = sp_l.vdim, sp_l.ndof_scalar

        def Dinv(w):  # byNODES layout: dof = v*nds + node
            w2 = w.reshape(vl, nds_l)
            z = jnp.einsum("nvw,wn->vn", Dblk_inv, w2)
            return z.reshape(-1)

    elif halo:
        De_inv = arrays["De_inv"]  # element-sharded [ne, ndl, ndl]
        Dinv = form.make_latent_dinv(De_inv)
    else:
        De_inv = arrays["De_inv"]
        ne, ndl = De_inv.shape[0], De_inv.shape[1]

        def Dinv(w):  # L2 dofs are element-contiguous: pure reshape
            we = w.reshape(ne, ndl)
            ze = jnp.einsum("eij,ej->ei", De_inv, we)
            return ze.reshape(-1)

    if halo:
        pad_u, pad_p = form.pad_u, form.pad_p
        split = form.split_u_p
    else:
        def pad_u(v):
            return jnp.concatenate([v, jnp.zeros(n1, v.dtype)])

        def pad_p(w):
            return jnp.concatenate([jnp.zeros(n0, w.dtype), w])

        def split(w):
            return w[:n0], w[n0:]

    def mv(v):
        return form.grad_mult_raw(tables, ess, state, v)

    def S(v):
        Jv = mv(pad_u(v))
        Av, Ctv = split(Jv)
        Cw = split(mv(pad_p(Dinv(Ctv))))[0]
        return Av + Cw

    M = None
    if "safe" in arrays:
        safe = arrays["safe"]
        if Mextra is None:
            M = lambda v: v / safe  # noqa: E731
        else:
            mx, complete = Mextra
            if complete:
                # the shifted V-cycle on S~ handles both the diffusion
                # block and the alpha-amplified reaction on its own
                M = mx
            else:
                # additive SPD combination: V-cycle on A (diffusion-
                # dominated dofs) + reaction diagonal (active set)
                M = lambda v: v / safe + mx(v)  # noqa: E731

    return S, M, Dinv, mv, pad_u, pad_p, n0, n1, split


def _schur_dir_chunked(form, opts, fp, x, b, fields, pdata,
                       reg: float = 1e-6, refine: int = 1):
    """Host-driven Schur Newton direction split into several jitted
    programs.

    Instead of the one-shot fused direction program, whose condensed-
    system CG can run thousands of preconditioned iterations at flagship
    sizes in one execution, this function splits the direction at the CG
    boundary:

        prep    residual + Jacobian state + elimination arrays (1 exec)
        chunk   ``lin_chunk`` PCG iterations, carry in/out       (N exec)
        finish  latent back-substitution dpsi = D^-1(C^T du - r) (1 exec)
        defect  r - J dx for the iterative-refinement passes     (1 exec)

    The PCG carry (iterate, residual, direction, scalars) stays on device
    between executions; the host reads back a 3-scalar status per chunk
    to decide convergence/stall/budget exit.  Whether the split costs
    anything against the one-shot program has not been measured on a
    GPU; see ``NewtonOptions.lin_chunk``.

    For non-L2 latents (``lumped``, the ex5 H1^dim case) the chunked
    program is the outer MINRES on the true saddle Jacobian instead, a
    few iterations per execution — each outer iteration applies the
    block preconditioner whose S~-solve is itself a bounded 200-it CG,
    so the per-execution budget is set by ``lin_chunk // 16`` outer its.
    """
    K = int(opts.lin_chunk)
    lumped = form.spaces[-1].fe_type != "L2"
    tables = form._tables()
    ess = form.ess_mask
    target2 = float(opts.lin_tol) ** 2  # vs ||r||/||b|| (normalized CG)

    def mx_of(pdata, arrays=None):
        # With arrays available, route through _primal_Mx so the exact-
        # elimination CG gets the SHIFTED V-cycle on A + diag(C D^-1 C^T)
        # (the additive Jacobi+V_A combination collapses in the mid-alpha
        # active-set transition: thousands of CG its at alpha=1.6, ex4/
        # ref-3 defaults, vs ~10^2 shifted).
        if arrays is not None:
            return _primal_Mx(fp, pdata, arrays)
        if fp is not None and hasattr(fp, "apply_primal"):
            return (lambda v: fp.apply_primal(pdata, v)), False
        return None

    def prep_fn(tables, ess, x, b, fields):
        r = form.mult_raw(tables, ess, x, fields) - b
        r = jnp.where(ess, 0.0, r)
        state = form.grad_state_raw(tables, x, fields)
        arrays = _schur_arrays(form, tables, ess, state, reg, True, lumped)
        return r, state, arrays

    if lumped:
        return _schur_dir_chunked_lumped(
            form, opts, fp, x, b, fields, pdata, prep_fn, K
        )

    def init_fn(tables, ess, state, arrays, pdata, rr):
        S, M, Dinv, mv, pad_u, pad_p, n0, _, split = _schur_ops(
            form, tables, ess, state, arrays, False, mx_of(pdata, arrays)
        )
        r_u, r_p = split(rr)
        rhs = r_u + split(mv(pad_p(Dinv(r_p))))[0]
        norm_b = jnp.linalg.norm(rhs)
        bsafe = jnp.where(norm_b == 0, 1.0, norm_b)
        bn = rhs / bsafe
        carry = _pcg_init(S, M if M is not None else (lambda v: v),
                          bn, jnp.zeros_like(bn), opts.lin_maxiter)
        return carry, bsafe

    def chunk_fn(tables, ess, state, arrays, pdata, carry):
        S, M, _, _, _, _, _, _, _ = _schur_ops(
            form, tables, ess, state, arrays, False, mx_of(pdata, arrays)
        )
        body, cond = _pcg_kernel(S, M if M is not None else (lambda v: v),
                                 target2, min(200, int(opts.lin_maxiter)))
        kend = jnp.minimum(carry[4] + K, carry[8])
        carry = carry[:8] + (kend,)
        out = jax.lax.while_loop(cond, body, carry)
        rs = jnp.vdot(out[1], out[1])
        status = jnp.stack([out[4].astype(rs.dtype), rs,
                            out[7].astype(rs.dtype)])
        return out[:8] + (jnp.asarray(opts.lin_maxiter, jnp.int32),), status

    def fin_fn(tables, ess, state, arrays, pdata, rr, carry, bsafe):
        _, _, Dinv, mv, pad_u, _, n0, _, split = _schur_ops(
            form, tables, ess, state, arrays, False, mx_of(pdata, arrays)
        )
        join = (form.join_u_p if hasattr(form, "join_u_p")
                else lambda a, b: jnp.concatenate([a, b]))
        du = carry[0] * bsafe
        dp = Dinv(split(mv(pad_u(du)))[1] - split(rr)[1])
        return join(du, dp)

    def defect_fn(tables, ess, state, r, dx):
        return r - form.grad_mult_raw(tables, ess, state, dx)

    fpid = id(fp) if fp is not None else None
    kbase = ("schur_chunked", opts.lin_tol, opts.lin_maxiter, K, reg, fpid)
    prep = form._jit(kbase + ("prep",), prep_fn)
    init = form._jit(kbase + ("init",), init_fn)
    chunk = form._jit(kbase + ("chunk",), chunk_fn)
    fin = form._jit(kbase + ("fin",), fin_fn)
    defect = form._jit(kbase + ("defect",), defect_fn)

    r, state, arrays = prep(tables, ess, x, b, fields)
    dx = None
    lin_its = 0
    for _ in range(1 + refine):
        rr = r if dx is None else defect(tables, ess, state, r, dx)
        carry, bsafe = init(tables, ess, state, arrays, pdata, rr)
        prev_k = -1
        while True:
            carry, status = chunk(tables, ess, state, arrays, pdata, carry)
            k, rs, stall = np.asarray(status)
            if (rs <= target2 or stall or k >= opts.lin_maxiter
                    or int(k) == prev_k):  # k frozen <=> gamma hit 0
                break
            prev_k = int(k)
        lin_its += int(k)
        d1 = fin(tables, ess, state, arrays, pdata, rr, carry, bsafe)
        dx = d1 if dx is None else dx + d1
    return dx, lin_its


_SWEEP_CACHE: dict = {}


def _sweep_inv_fn(n_pad: int, b: int):
    """Jitted blocked Gauss-Jordan SWEEP inversion, cached per shape.

    Sweeping every pivot block of an SPD matrix in place yields -A^-1
    (the classical SWEEP operator, composed blockwise): for pivot block
    k with P = inv(A[k,k]) and col = A[:, k],

        A   <- A - col P col^T        (full symmetric rank-b update)
        A[:, k] <- col P;  A[k, :] <- (col P)^T;  A[k, k] <- -P

    One fori_loop program with input donation: peak device memory is
    ~2 n^2 f32 (the loop-carried matrix, double-buffered) instead of the
    ~5 n^2 of a recursive 2x2 block elimination.  ~2 n^3 flops of
    [n, b] GEMMs."""
    key = (n_pad, b)
    fn = _SWEEP_CACHE.get(key)
    if fn is None:
        nb = n_pad // b

        def sweep(A):
            def step(i, A):
                k0 = i * b
                P = jnp.linalg.inv(
                    jax.lax.dynamic_slice(A, (k0, k0), (b, b)))
                col = jax.lax.dynamic_slice(A, (0, k0), (n_pad, b))
                CP = col @ P
                A = A - CP @ col.T
                A = jax.lax.dynamic_update_slice(A, CP, (0, k0))
                A = jax.lax.dynamic_update_slice(A, CP.T, (k0, 0))
                A = jax.lax.dynamic_update_slice(A, -P, (k0, k0))
                return A

            return -jax.lax.fori_loop(0, nb, step, A)

        fn = jax.jit(sweep, donate_argnums=0)
        _SWEEP_CACHE[key] = fn
    return fn


def _inv_f32_accel(S):
    """f32 inverse of a symmetric (near-)SPD matrix on the accelerator.

    n <= leaf (default 8192): one ``jnp.linalg.inv``.  Above the leaf:
    the blocked SWEEP program (``_sweep_inv_fn``), identity-padded to a
    block multiple, whose peak memory is ~2 n^2.  The result stays on
    the device; every consumer (Sigma-CG, the LDU primal surrogate)
    applies it as a device GEMM.  A device failure propagates: the
    callers' matrix-free fallbacks decide what happens next."""
    leaf = int(_os.environ.get("MFEM_AD_TPU_INV_LEAF", "8192"))
    n = S.shape[0]
    if n <= leaf:
        Sd = jnp.asarray(S, dtype=jnp.float32)
        out = jax.block_until_ready(jnp.linalg.inv(Sd))
        return 0.5 * (out + out.T)
    b = int(_os.environ.get("MFEM_AD_TPU_SWEEP_BLOCK", "1024"))
    n_pad = -(-n // b) * b
    Sp = np.zeros((n_pad, n_pad), np.float32)
    Sp[:n, :n] = np.asarray(S, dtype=np.float32)
    idx = np.arange(n, n_pad)
    Sp[idx, idx] = 1.0
    out = jax.block_until_ready(_sweep_inv_fn(n_pad, b)(jnp.asarray(Sp)))
    out = out[:n, :n]
    return 0.5 * (out + out.T)


def _sigma_direct_enabled(form, opts, fp, nl: int) -> bool:
    """Gate for the direct (dense-factorized) dual-Schur preconditioner.

    On by default ("auto") up to a latent-size cap: the scaled dual Schur
    complement Sigma = alpha^2 D + alpha^2 C^T V_A C is the 93-CG-it
    bottleneck of the LDU direction (measured at the converged ex5 ref-2
    state: node-block-preconditioned kappa = 2.3e4 with >500 eigenvalues
    below 1e-2 lambda_max — a smeared continuum no coarse correction or
    deflation can capture; a Galerkin two-level cut kappa only 22.8k ->
    19.5k).  A dense inverse is the honest fix at example scales —
    the reference solves the WHOLE saddle with a direct method (MUMPS,
    tools.hpp:128-154); we factor only the latent Schur block (4x fewer
    rows) and keep everything else matrix-free.  Above the cap the
    node-block-CG path remains (O(n) memory)."""
    if not getattr(opts, "sigma_direct", "auto"):
        return False
    if hasattr(form, "schur_arrays_raw"):  # sharded: element axis is
        return False  # distributed; the dense build is a serial-form tool
    if fp is None or not hasattr(fp, "apply_primal"):
        return False
    cap = int(_os.environ.get("MFEM_AD_TPU_SIGMA_DIRECT_MAX", "16384"))
    return nl <= cap


def _sigma_direct_update(form, fp, tables, ess, state, pdata, alpha_f,
                         n0: int, nl: int):
    """Build/refresh the dense inverse of the scaled dual Schur complement
    Sigma(alpha) = alpha^2 D + K,  K = (alpha C)^T V_A (alpha C),
    cached on ``fp`` (which persists across the PG outer loop).

    The split is the whole trick: K is alpha- AND state-invariant for
    LVPP functionals with linear primal-latent coupling (C is exactly
    (1/alpha) x a constant mixed mass, pg.hpp:193-213), so K is paid ONCE
    per run; each refresh only re-assembles the element-local weighted
    latent mass alpha^2 D (E*'' at the current psi) and re-inverts.
    Invariance is spot-checked numerically at every refresh (one fresh
    raw-Jacobian column vs the cache); drift demotes K to
    rebuild-on-refresh, so nonlinear couplings stay correct, just slower.

    Two K builders (both cached under the same contract):
    - **gemm** (default when the dense primal block fits): assemble the
      primal block A and the coupling alpha*C densely (element-local
      scatter, one pass), invert A in f32 on the device
      (``_inv_f32_accel``), K = (alpha C)^T A^-1 (alpha C) — two GEMMs.
      This replaces the round-3 column build (nl V-cycle matvecs, ~20
      min of the first ex5 ref-3 direction) with seconds, and the exact
      A^-1 is a *better* inner surrogate than one V-cycle.  A^-1 is kept
      on device and reused inside the LDU apply (see ``ops``).
    - **matvec** (fallback): nl vmapped columns of (alpha C)^T V_A
      (alpha C) through the matrix-free Jacobian action and the GMG
      V-cycle — no dense primal block required.

    Refresh policy (lazy): alpha moved by more than 4x since the factor
    was built, or the previous direction's outer FGMRES count exceeded 12
    (staleness signal — the Sigma-CG wrapped around this preconditioner
    keeps every direction CORRECT regardless; only iteration counts
    drift).  The inverse itself is computed in f32 on the device (GEMMs
    at any size) — see ``_inv_f32_accel``."""
    cache = getattr(fp, "_sigma_cache", None)
    if cache is None or cache.get("nl") != nl:
        cache = fp._sigma_cache = {"nl": nl}

    def kcols_fn(tables, ess, state, pdata, alpha, Vblk):
        def one(w):
            t2 = form.grad_mult_raw(
                tables, ess, state,
                jnp.concatenate([jnp.zeros(n0, w.dtype), w]))
            z = fp.apply_primal(pdata, t2[:n0])
            t3 = form.grad_mult_raw(
                tables, ess, state,
                jnp.concatenate([z, jnp.zeros(nl, w.dtype)]))
            return (alpha * alpha) * t3[n0:]
        return jax.vmap(one)(Vblk)

    def de_fn(tables, state):
        lb = len(form.offsets) - 2
        intg = form.integrators[0]
        return -intg.element_matrices(state[0], lb, lb, tables=tables[0])

    alpha_j = jnp.asarray(alpha_f)
    if "gi" not in cache:
        lb = len(form.offsets) - 2
        sp_l = form.spaces[lb]
        edof_l = np.asarray(form.integrators[0].tables["edof"][lb])
        idx = edof_l[:, :, None] + np.arange(sp_l.vdim) * sp_l.ndof_scalar
        # byNODES element layout: flat (v, d) = v*nd + d
        cache["gi"] = np.transpose(idx, (0, 2, 1)).reshape(idx.shape[0], -1)

    def build_K():
        ne, nq, n = state[0].shape[:3]
        # bs x (ne nq n) f64 intermediates per vmapped matvec; sized so
        # the one-time column build is ~nl/128 large device calls, not
        # ~nl/8 small ones.  On a runtime failure (device memory) halve
        # and retry.
        bs = int(np.clip(4e8 // max(int(ne) * int(nq) * int(n), 1), 8, 128))
        bs = min(bs, nl)
        while True:
            try:
                kj = form._jit(("sigma_kcols", bs), kcols_fn)
                cols = []
                eye = np.eye(nl)
                for i in range(0, nl, bs):
                    blk = eye[i:i + bs]
                    if blk.shape[0] < bs:  # keep one compiled shape
                        blk = np.concatenate(
                            [blk, np.zeros((bs - blk.shape[0], nl))])
                    cols.append(np.asarray(
                        kj(tables, ess, state, pdata, alpha_j,
                           jnp.asarray(blk))))
                break
            except jax.errors.JaxRuntimeError:
                if bs <= 8:
                    raise
                bs //= 2
        K = np.concatenate(cols, axis=0)[:nl].T
        return 0.5 * (K + K.T)

    ess_np = np.asarray(ess)
    pe, le = ess_np[:n0], ess_np[n0:]

    def build_AC():
        """Dense primal block A (essential rows/cols -> identity) and the
        alpha-invariant coupling alpha*C, assembled element-locally —
        matches grad_mult_raw's eliminated-BC convention."""
        lb = len(form.spaces) - 1
        offs = np.asarray(form.offsets)
        A = np.zeros((n0, n0), np.float32)
        Cm = np.zeros((n0, nl), np.float32)
        for intg, Hq in zip(form.integrators, state):
            for s_ in range(lb):
                r0_, r1_ = offs[s_], offs[s_ + 1]
                for t_ in range(lb):
                    A[r0_:r1_, offs[t_]:offs[t_ + 1]] += (
                        intg.assemble_dense_block(Hq, s_, t_))
                Cm[r0_:r1_, :] += intg.assemble_dense_block(Hq, s_, lb)
        A[pe, :] = 0.0
        A[:, pe] = 0.0
        A[pe, pe] = 1.0
        Cm[pe, :] = 0.0
        Cm[:, le] = 0.0
        return A, Cm * np.float32(alpha_f)

    def build_K_gemm():
        A, Ca = build_AC()
        # invariance witness: one raw-Jacobian column (A[:,j], alpha*C[j,:])
        j = int(np.argmax(~pe))  # first non-essential primal dof
        cache["chk"] = (j, A[:, j].copy(), Ca[j, :].copy())
        Ainv = _inv_f32_accel(A)
        del A
        # K stays ON DEVICE (~0.7 GB at ref-3 scale): every consumer adds
        # it to Sigma on the device anyway.
        Ca_d = jnp.asarray(Ca)
        K = Ca_d.T @ (Ainv @ Ca_d)
        cache["Ainv"] = Ainv
        return jax.block_until_ready(0.5 * (K + K.T))

    def gemm_ok():
        if _os.environ.get("MFEM_AD_TPU_SIGMA_GEMM", "1") == "0":
            return False
        if not all(hasattr(i, "assemble_dense_block")
                   for i in form.integrators):
            return False
        # peak-device-memory estimate (f32): the SWEEP inversion double-
        # buffers the n0 x n0 matrix (2x), plus the retained A^-1 slice,
        # the coupling + GEMM temp, and K — all next to resident solver
        # state, so the estimate must fit in 3/4 of the device's memory.
        budget = 0.75 * _device_bytes_limit()
        return 4.0 * (3.0 * n0 * n0 + 2.0 * n0 * nl + nl * nl) < budget

    def check_drift():
        """One grad_mult_raw column vs the cached witness; returns True
        when the dense A/C snapshot no longer matches the live Jacobian
        (nonlinear primal energy or coupling)."""
        if cache.get("mode") == "gemm":
            j, colA, colC = cache["chk"]
            ej = np.zeros(form.ndof)
            ej[j] = 1.0
            k1 = form._jit(("sigma_rawcol",), lambda t, e, s, v:
                           form.grad_mult_raw(t, e, s, v))
            col = np.asarray(k1(tables, ess, state, jnp.asarray(ej)))
            dA = np.linalg.norm(col[:n0] - colA)
            dC = np.linalg.norm(alpha_f * col[n0:] - colC)
            den = max(float(np.linalg.norm(colA)),
                      float(np.linalg.norm(colC)), 1e-30)
            # 1e-5: above the f32 assembly rounding of the witness, far
            # below any real state drift
            return (dA + dC) > 1e-5 * den
        j = nl // 2
        ej = np.zeros(nl)
        ej[j] = 1.0
        k1 = form._jit(("sigma_kcols", 1), kcols_fn)
        col = np.asarray(k1(tables, ess, state, pdata, alpha_j,
                            jnp.asarray(ej[None, :])))[0]
        ref = cache["K"][:, j]
        den = max(float(np.linalg.norm(ref)), 1e-30)
        return float(np.linalg.norm(col - ref)) > 1e-8 * den

    def rebuild_K():
        """Build K in the cached mode; a device failure (OOM next to
        resident solver state) demotes gemm -> matvec permanently for
        this cache rather than killing the run."""
        if cache["mode"] == "gemm":
            try:
                return build_K_gemm()
            except (jax.errors.JaxRuntimeError, RuntimeError):
                cache["mode"] = "matvec"
                cache.pop("Ainv", None)
        return build_K()

    if "K" not in cache:
        cache["mode"] = "gemm" if gemm_ok() else "matvec"
        cache["K"] = rebuild_K()
        cache["k_dynamic"] = False
    # Lazy refresh: the Sigma-CG wrapped around this preconditioner keeps
    # every direction correct regardless of staleness, and a factor built
    # at alpha0 applied at alpha has spectral distortion <= (alpha/alpha0)^2
    # (S = alpha^2 D + K, only the D part drifts) — CG absorbs kappa<=16 in
    # a handful of iterations.  So re-invert only every 2 alpha-doublings,
    # or when the previous direction's outer FGMRES count says the factor
    # went stale (host inversion is minutes at nl~13k on a 1-core host;
    # per-alpha refresh was the wall-time bottleneck of ex5 ref-3).
    a_prev = cache.get("alpha")
    a_ratio = (max(alpha_f, a_prev) / max(min(alpha_f, a_prev), 1e-300)
               if a_prev else np.inf)
    refresh = (
        "Sinv" not in cache
        or a_ratio > 4.0
        or cache.get("outer_prev", 0) > 12
    )
    if refresh:
        if cache["k_dynamic"] or check_drift():
            cache["k_dynamic"] = True
            cache["K"] = rebuild_K()
        dej = form._jit(("sigma_de",), de_fn)
        De = np.asarray(dej(tables, state))
        gi = cache["gi"]
        S = np.zeros((nl, nl))
        np.add.at(S, (gi[:, :, None], gi[:, None, :]), De)
        S *= alpha_f * alpha_f
        K = cache["K"]
        if isinstance(K, np.ndarray):
            S += K
            if le.any():  # grad_mult_raw treats essential dofs as identity
                S[le, :] = 0.0
                S[:, le] = 0.0
                S[le, le] = 1.0
            S = 0.5 * (S + S.T)
            S[np.diag_indices_from(S)] += 1e-14 * float(
                np.abs(np.diag(S)).max())
            Sfull = S
        else:
            # gemm mode: K lives on the device; assemble Sigma there too
            # (only the small alpha^2 D scatter crosses h2d) and never
            # pull an nl x nl array back to the host.
            if "le_mask" not in cache:
                cache["le_mask"] = jnp.asarray(~le, dtype=jnp.float32)
                cache["le_add"] = jnp.asarray(le, dtype=jnp.float32)
            Sd = jnp.asarray(S, dtype=jnp.float32) + K
            lm = cache["le_mask"]
            Sd = Sd * lm[:, None] * lm[None, :]
            Sd = 0.5 * (Sd + Sd.T)
            dmax = jnp.abs(jnp.diagonal(Sd)).max()
            # diagonal fix via scatter-add (NOT jnp.eye: under x64 its
            # i64 iota temporaries are ~4x nl^2 bytes — measured OOM)
            di = jnp.arange(nl)
            Sfull = Sd.at[di, di].add(cache["le_add"] + 1e-14 * dmax)
        # invert in f32 — a preconditioner needs ~3 digits (kappa(S)~1e4
        # -> inverse accurate to ~1e-3 relative) and the surrounding CG
        # supplies the rest.  _inv_f32_accel runs on the device at any
        # size (blocked SWEEP above its leaf size).
        cache["Sinv"] = _inv_f32_accel(Sfull)
        cache["alpha"] = alpha_f
    return cache


def _ldu_fgmres(form, opts, fp, x, b, fields, pdata, prep_fn):
    """Flexible GMRES on the saddle Jacobian J = [[A, C], [C^T, -D]] with
    the inexact block-LDU preconditioner

        J = [[I, 0], [C^T A^-1, I]] [[A, 0], [0, -Sigma]]
            [[I, A^-1 C], [0, I]],      Sigma = D + C^T A^-1 C,

    applied as  zu' = A^-1 ru;  zp = -Sigma^-1 (rp - C^T zu');
    zu = A^-1 (ru - C zp), with
      - A^-1: GMG-CG on the primal objective block (V-cycle
        preconditioned, rel tol 1e-5 — mesh-independent ~5-10 its),
      - Sigma^-1: CG on the matrix-free operator w -> D w + C^T V_A(C w)
        (V_A = one V-cycle, spectrally equivalent to A^-1),
        preconditioned by the node-block arrays["Sig_blk_inv"]
        (_schur_arrays_core), rel tol 3e-3.

    The replacement for the reference's distributed MUMPS on the ex5
    saddle (tools.hpp:128-154): outer counts are alpha- and
    mesh-independent (measured 7-11), every inner piece is bounded, and
    each outer iteration is one jitted program.  Host-side
    Arnoldi: vectors move host<->device once per outer iteration (~MBs);
    H stays on host (classical Gram-Schmidt, lstsq of a <=32x32 system).
    """
    A_TOL, A_MAX = 1e-5, 64
    S_TOL, S_MAX = 3e-3, 200
    # Inner budgets of one FGMRES step (2 A-CG solves + the Sigma-CG);
    # MFEM_AD_TPU_LDU_AMAX / _SMAX override.
    A_MAX = int(_os.environ.get("MFEM_AD_TPU_LDU_AMAX", A_MAX))
    S_MAX = int(_os.environ.get("MFEM_AD_TPU_LDU_SMAX", S_MAX))
    tables = form._tables()
    ess = form.ess_mask
    off = form.offsets
    n0 = int(off[len(off) - 2])
    sp_l = form.spaces[-1]
    vl, nds_l = sp_l.vdim, sp_l.ndof_scalar
    tol = float(opts.lin_tol)
    budget = int(opts.lin_maxiter)  # honored in full; each outer
    # iteration is one bounded execution (8-15 suffice at every alpha)
    m = min(32, budget)  # restart length
    # alpha-scaled system: the raw PG Jacobian's latent rows/cols carry a
    # 1/alpha weight, so at alpha=1e6 a saddle-residual tol of 1e-8 still
    # admits O(1) errors in dpsi (measured: the PG loop diverges at
    # alpha >= 5e5 with directions that pass the residual test).  Solving
    # the symmetrically scaled system Lam J Lam zhat = Lam r with
    # Lam = blockdiag(I, alpha I) — algebraically the reference's
    # lambda-formulation ADLambdaPGFunctional (pg.hpp:216-243) — makes
    # every block O(1) and the residual tolerance measure lambda-accuracy
    # directly; dpsi = alpha * zhat_p.
    alpha_f = float(fields.get("alpha", 1.0)) if fields else 1.0
    nl = form.ndof - n0
    use_direct = _sigma_direct_enabled(form, opts, fp, nl)

    def ops(tables, ess, state, arrays, pdata, alpha, sinv=None,
            ainv=None, sdata=None):
        def mvraw(v):
            return form.grad_mult_raw(tables, ess, state, v)

        def scale(v):
            return jnp.concatenate([v[:n0], alpha * v[n0:]])

        def mvfull(v):  # scaled saddle operator Lam J Lam
            return scale(mvraw(scale(v)))

        if ainv is not None:
            # gemm-mode sigma-direct: the dense f32 A^-1 (already paid
            # for building K) replaces the V-cycle as the inner primal
            # surrogate — one GEMM per apply, and it is the *exact*
            # inverse the Sigma factor was built from, so the Sigma-CG
            # preconditioner is consistent with its operator.
            def V_A(v):
                return (ainv @ v.astype(ainv.dtype)).astype(v.dtype)
        else:
            def V_A(v):
                return fp.apply_primal(pdata, v)

        a2 = alpha * alpha

        def pad_u(v):
            return jnp.concatenate([v, jnp.zeros(form.ndof - n0, v.dtype)])

        def pad_p(w):
            return jnp.concatenate([jnp.zeros(n0, w.dtype), w])

        if sinv is not None:
            # direct mode: dense inverse of the scaled Sigma as the CG
            # preconditioner — one GEMM; 1-3 its when fresh, self-healing
            # (more its) when stale.  See _sigma_direct_update.
            s_max = min(S_MAX, 50)

            def SigM(w):  # f32 GEMM; CG supplies the f64 digits
                return (sinv @ w.astype(sinv.dtype)).astype(w.dtype)
        elif sdata is not None:
            # WOODBURY mode (round 4, VERDICT r3 #3 — removes the
            # sigma-direct size cliff): the dual Schur complement obeys
            #   (D~ + C^T A^-1 C)^-1
            #     = D~^-1 - D~^-1 C^T (A + C D~^-1 C^T)^-1 C D~^-1
            # and the inner operator A + C D~^-1 C^T is exactly the
            # (lumped) PRIMAL Schur complement S~ the shifted GMG V-cycle
            # already preconditions (arrays["dshift"] carries its
            # reaction diagonal).  One shifted V-cycle + two couplings +
            # two node-block solves per apply — matrix-free, O(ndof)
            # memory, any problem size, valid on sharded forms.  The
            # node-block D~ (regularized) stands in for D; its lumping/
            # regularization error only shifts the Sigma-CG count by a
            # modest constant (the wrapping CG keeps every direction
            # exact).
            Dblk_inv = arrays["Dblk_inv"]
            s_max = min(S_MAX, 60)

            def Dtinv(w):  # byNODES layout: dof = v*nds + node
                w2 = w.reshape(vl, nds_l)
                return jnp.einsum("nvw,wn->vn", Dblk_inv, w2).reshape(-1)

            def SigM(w):
                z0 = Dtinv(w)
                t1 = mvraw(pad_p(z0))[:n0]  # C z0
                z1 = fp.apply_primal(pdata, t1, sdata)  # V on S~
                t2 = mvraw(pad_u(z1))[n0:]  # C^T z1
                return (z0 - Dtinv(t2)) / a2
        else:
            Sig_blk_inv = arrays["Sig_blk_inv"]
            s_max = S_MAX

            def SigM(w):  # (alpha^2 Sigma)^-1 approx
                w2 = w.reshape(vl, nds_l)
                z = jnp.einsum("nvw,wn->vn", Sig_blk_inv, w2).reshape(-1)
                return z / a2

        def Asolve(rhs):
            return cg(lambda v: mvraw(pad_u(v))[:n0], rhs, M=V_A,
                      tol=A_TOL, maxiter=A_MAX, stall_window=None)

        def Sig_mv(w):  # scaled dual Schur: alpha^2 (D + C^T V_A C)
            t2 = mvraw(pad_p(w))
            return a2 * (-t2[n0:] + mvraw(pad_u(V_A(t2[:n0])))[n0:])

        def M_ldu(r):
            ru, rp = r[:n0], r[n0:]
            zu1 = Asolve(ru)
            zp = -cg(Sig_mv, rp - alpha * mvraw(pad_u(zu1))[n0:], M=SigM,
                     tol=S_TOL, maxiter=s_max, stall_window=None)
            zu = Asolve(ru - alpha * mvraw(pad_p(zp))[:n0])
            return jnp.concatenate([zu, zp])

        return mvfull, M_ldu

    def step_fn(tables, ess, state, arrays, pdata, alpha, v):
        mvfull, M_ldu = ops(tables, ess, state, arrays, pdata, alpha)
        z = M_ldu(v)
        return z, mvfull(z)

    def step_fn_direct(tables, ess, state, arrays, pdata, alpha, sinv,
                       ainv, v):
        mvfull, M_ldu = ops(tables, ess, state, arrays, pdata, alpha,
                            sinv, ainv)
        z = M_ldu(v)
        return z, mvfull(z)

    def step_fn_wb(tables, ess, state, arrays, pdata, sdata, alpha, v):
        mvfull, M_ldu = ops(tables, ess, state, arrays, pdata, alpha,
                            sdata=sdata)
        z = M_ldu(v)
        return z, mvfull(z)

    def sdata_fn(arrays, pdata):
        # shifted-V-cycle data for S~ = A + diag(C D~^-1 C^T): restricted
        # reaction diagonals + shifted coarse inverse, once per direction
        return fp.shift_data(pdata, arrays["dshift"])

    def mvs_fn(tables, ess, state, alpha, v):
        def mvraw(w):
            return form.grad_mult_raw(tables, ess, state, w)

        out = mvraw(jnp.concatenate([v[:n0], alpha * v[n0:]]))
        return jnp.concatenate([out[:n0], alpha * out[n0:]])

    # Sigma preconditioner mode: dense-direct inside the size cap, else
    # the matrix-free Woodbury apply (needs a shift-capable GMG), else
    # the legacy node-block diagonal.  MFEM_AD_TPU_SIGMA_WOODBURY=0
    # restores the node-block fallback for A/B.
    use_wb = (
        not use_direct
        and fp is not None
        and hasattr(fp, "shift_data")
        and _os.environ.get("MFEM_AD_TPU_SIGMA_WOODBURY", "1") != "0"
    )
    mode = "direct" if use_direct else ("wb" if use_wb else "blk")
    kb = ("schur_ldu", tol, m, A_TOL, A_MAX, S_TOL, S_MAX, id(fp))
    prep = form._jit(kb + ("prep",), prep_fn)
    step = form._jit(
        kb + ("step", mode),
        {"direct": step_fn_direct, "wb": step_fn_wb, "blk": step_fn}[mode],
    )
    mvj = form._jit(kb + ("mv",), mvs_fn)

    alpha_j = jnp.asarray(alpha_f)
    _dbg = _os.environ.get("MFEM_AD_TPU_LDU_DEBUG")
    _t0 = _time.perf_counter()
    r0, state, arrays = prep(tables, ess, x, b, fields)
    r0 = np.array(r0)
    sd = None
    sdata = None
    if use_direct:
        sd = _sigma_direct_update(form, fp, tables, ess, state, pdata,
                                  alpha_f, n0, nl)
    elif use_wb:
        sdata = form._jit(kb + ("sdata",), sdata_fn)(arrays, pdata)
    _t_prep, _t_step, _t_rest = _time.perf_counter() - _t0, 0.0, 0.0
    r0[n0:] *= alpha_f  # scaled rhs Lam r
    beta0 = float(np.linalg.norm(r0))
    dx = np.zeros_like(r0)
    if beta0 == 0.0:
        return jnp.asarray(dx), 0
    target = tol * beta0
    total = 0
    rel_prev = 1.0
    r_cur = r0
    while total < budget:
        beta = float(np.linalg.norm(r_cur))
        if beta <= target:
            break
        V = np.empty((m + 1, r0.shape[0]))
        V[0] = r_cur / beta
        Z = np.empty((m, r0.shape[0]))
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = beta
        j_done = 0
        y = None
        for j in range(m):
            _t0 = _time.perf_counter()
            if use_direct:
                z, w = step(tables, ess, state, arrays, pdata, alpha_j,
                            sd["Sinv"], sd.get("Ainv"),
                            jnp.asarray(V[j]))
            elif use_wb:
                z, w = step(tables, ess, state, arrays, pdata, sdata,
                            alpha_j, jnp.asarray(V[j]))
            else:
                z, w = step(tables, ess, state, arrays, pdata, alpha_j,
                            jnp.asarray(V[j]))
            Z[j] = np.asarray(z)
            w = np.array(w)
            _t_step += _time.perf_counter() - _t0
            h = V[: j + 1] @ w
            w -= h @ V[: j + 1]
            h2 = V[: j + 1] @ w  # CGS2: re-orthogonalize (classical
            w -= h2 @ V[: j + 1]  # GS alone loses orthogonality by ~1e-7
            h += h2               # at tight tols, flooring the true rel)
            H[: j + 1, j] = h
            H[j + 1, j] = np.linalg.norm(w)
            total += 1
            j_done = j + 1
            y, *_ = np.linalg.lstsq(H[: j + 2, : j + 1], g[: j + 2],
                                    rcond=None)
            rn = float(np.linalg.norm(H[: j + 2, : j + 1] @ y
                                      - g[: j + 2]))
            if rn <= target or H[j + 1, j] < 1e-30 or total >= budget:
                break
            V[j + 1] = w / H[j + 1, j]
        dx = dx + y @ Z[:j_done]
        _t0 = _time.perf_counter()
        r_cur = r0 - np.asarray(
            mvj(tables, ess, state, alpha_j, jnp.asarray(dx))
        )
        _t_rest += _time.perf_counter() - _t0
        rel = float(np.linalg.norm(r_cur)) / beta0
        if rel <= tol or rel > 0.95 * rel_prev:
            break  # converged, or the restart made <5% progress
        rel_prev = rel
    if _dbg:
        rel_f = float(np.linalg.norm(r_cur)) / beta0
        print(f"    [ldu] beta0={beta0:.3e} rel={rel_f:.3e} its={total} "
              f"alpha={alpha_f:.3g} prep={_t_prep:.2f}s "
              f"steps={_t_step:.2f}s ({_t_step/max(total,1)*1e3:.0f} "
              f"ms/it) restart_mv={_t_rest:.2f}s"
              f" [sigma-{mode}]", flush=True)
    if sd is not None:
        sd["outer_prev"] = total
    dx[n0:] *= alpha_f  # unscale: the direction is Lam zhat
    return jnp.asarray(dx), total


def _schur_dir_chunked_lumped(form, opts, fp, x, b, fields, pdata,
                              prep_fn, K: int):
    """Direction solve for non-L2 (lumped) latents — ex5's H1^dim
    Hellinger latent (ex5.cpp:114-140).

    With a GMG (``fp``): **flexible GMRES on the true saddle Jacobian
    with an inexact block-LDU preconditioner** (``_ldu_fgmres``).
    Diagnosed round 3 with dense ref-1 probes: any block-DIAGONAL
    preconditioner built from a lumped D~ floors MINRES on this system —
    blockdiag(exact S~^-1, D~^-1) needed 78 iterations at alpha=64 and
    839 at alpha=1e6 (Hellinger's E*'' goes rank-deficient along psi at
    saturation, so no node-local approximation of D captures the latent
    block) — while blocks built from the DUAL Schur complement
    Sigma = D + C^T A^-1 C measured 31 -> 42 iterations, flat in alpha.
    The LDU factorization applies exactly that structure with matrix-free
    inexact inner solves; measured 7-11 outer iterations flat in alpha
    where the previous shifted-V-cycle MINRES needed 2000-6000,
    budget-floored (the lambda = 2.5e-7 ex5 floor of VERDICT r2 #1).

    Without a GMG: the legacy block-diag MINRES with a bounded inner CG
    on S~ (small chunks)."""
    if fp is not None:
        return _ldu_fgmres(form, opts, fp, x, b, fields, pdata, prep_fn)
    Kout, outer_maxiter = max(1, K // 16), 200
    tables = form._tables()
    ess = form.ess_mask
    tol = float(opts.lin_tol)

    def ops_of(tables, ess, state, arrays, pdata):
        S, M, Dinv, mv, pad_u, pad_p, n0, _, _ = _schur_ops(
            form, tables, ess, state, arrays, True,
            _primal_Mx(fp, pdata, arrays),
        )
        # fp is None here (the fp path returned into _ldu_fgmres above)
        Mu = lambda rr_u: cg(S, rr_u, M=M, tol=1e-8, maxiter=200)  # noqa: E731

        def Mblock(rr):
            return jnp.concatenate([Mu(rr[:n0]), Dinv(rr[n0:])])

        return mv, Mblock

    def init_fn(tables, ess, state, arrays, pdata, rr):
        mv, Mblock = ops_of(tables, ess, state, arrays, pdata)
        return _minres_init(mv, Mblock, rr, jnp.zeros_like(rr),
                            outer_maxiter)

    def chunk_fn(tables, ess, state, arrays, pdata, rr, carry):
        mv, Mblock = ops_of(tables, ess, state, arrays, pdata)
        target = tol * jnp.maximum(jnp.linalg.norm(rr), 1e-30)
        body, cond = _minres_kernel(mv, Mblock, target,
                                    min(200, outer_maxiter))
        kend = jnp.minimum(carry[13] + Kout, carry[16])
        carry = carry[:16] + (kend,)
        out = jax.lax.while_loop(cond, body, carry)
        phibar = out[8]
        status = jnp.stack([
            out[13].astype(phibar.dtype), phibar / target,
            out[15].astype(phibar.dtype),
        ])
        return out[:16] + (jnp.asarray(outer_maxiter, jnp.int32),), status

    kbase = ("schur_chunked_lumped", opts.lin_tol, outer_maxiter, Kout,
             id(fp) if fp is not None else None)
    prep = form._jit(kbase + ("prep",), prep_fn)
    init = form._jit(kbase + ("init",), init_fn)
    chunk = form._jit(kbase + ("chunk",), chunk_fn)

    r, state, arrays = prep(tables, ess, x, b, fields)
    carry = init(tables, ess, state, arrays, pdata, r)
    prev_k = -1
    while True:
        carry, status = chunk(tables, ess, state, arrays, pdata, r, carry)
        k, rel, stall = np.asarray(status)
        if (rel <= 1.0 or stall or k >= outer_maxiter
                or int(k) == prev_k):
            break
        prev_k = int(k)
    return carry[0], int(k)


def make_pg_schur_solver(latent_block: int = 1, tol: float = 1e-12,
                         maxiter: int = 2000, jacobi: bool = True,
                         reg: float = 1e-6):
    """Exact Schur reduction of the LVPP saddle Jacobian — the matrix-free
    replacement for the reference's monolithic MUMPS solve (tools.hpp:
    128-154, used at ex4.cpp:166).

    The block Jacobian is [[A, C], [C^T, -D]] with D = (E*''/alpha)-weighted
    latent mass.  When the latent space is L2, D is **element-block-diagonal**
    (L2 dofs never couple across elements), so D^{-1} is a batched dense
    solve of [ne, nd, nd] blocks — exact, local, and cheap.  Eliminating
    psi gives the SPD condensed system

        (A + C D^{-1} C^T) du = r_u + C D^{-1} r_psi,
        dpsi = D^{-1} (C^T du - r_psi),

    solved with Jacobi-preconditioned CG.  This is the structure the
    reference's PGPreconditioner approximates (pg.hpp:378-504); here the
    latent block is handled exactly instead.

    Returns a callable suitable for ``NewtonOptions.lin_solver``.  The form
    must have exactly one integrator and the latent space must be L2
    (element-contiguous dofs).
    """

    def solve(form, state, r):
        off = form.offsets
        if len(off) != 3 or latent_block != len(off) - 2:
            raise ValueError(
                "make_pg_schur_solver requires a 2-block (primal, latent) "
                f"system with the latent block last; got {len(off) - 1} "
                f"blocks, latent_block={latent_block}"
            )
        key = ("schur_solve", tol, maxiter, reg, jacobi)
        fn = form._jit(
            key,
            lambda tables, ess, state, r: _schur_solve_traced(
                form, tables, ess, state, r, tol, maxiter, reg, jacobi
            ),
        )
        return fn(form._tables(), form.ess_mask, state, r)

    return solve


# ---------------------------------------------------------------------------
# Newton
# ---------------------------------------------------------------------------


@dataclass
class NewtonOptions:
    abs_tol: float = 1e-12
    rel_tol: float = 0.0
    max_iter: int = 100
    damping: float = 1.0  # MFEM's c scaling factor (default 1)
    # linear solver: "dense" | "cg" | "minres" | "gmres" | callable
    lin_solver: object = "cg"
    lin_tol: float = 1e-12
    lin_maxiter: int = 2000
    # PCG iterations per jitted program for the chunked schur path
    # (None = one-shot fused program): the direction is split into
    # several programs with a host status read between them; see
    # _schur_dir_chunked.  Whether the split costs anything against the
    # one-shot program is not measured yet.
    lin_chunk: object = 64
    preconditioner: object = None  # None | "jacobi" | callable(form,state)->M
    verbose: bool = False
    # consecutive <5% residual reductions before Newton gives up as
    # floored (see the stagnation break in newton()); None disables, so
    # slow-but-steady runs grind to abs_tol within max_iter as before
    stall_iters: object = 2
    # dense-factorized dual-Schur preconditioner for the LDU-FGMRES
    # saddle direction ("auto" = on for serial forms up to
    # MFEM_AD_TPU_SIGMA_DIRECT_MAX latent dofs); see _sigma_direct_enabled
    sigma_direct: object = "auto"


@dataclass
class NewtonResult:
    x: object
    converged: bool
    iterations: int
    final_norm: float
    history: list = field(default_factory=list)
    # total Krylov iterations per Newton iteration (chunked schur path
    # only — the one-shot fused programs don't report counts)
    lin_iters: list = field(default_factory=list)


def _make_precond(form, state, spec):
    if spec is None:
        return None
    if spec == "jacobi":
        # |diag| keeps the preconditioner SPD on indefinite (saddle)
        # systems so it is valid for MINRES as well as CG
        d = jnp.abs(form.grad_diag(state))
        safe = jnp.where(d < 1e-30, 1.0, d)
        return lambda x: x / safe
    if callable(spec):
        return spec(form, state)
    raise ValueError(f"unknown preconditioner {spec!r}")


def _fused_newton_step(form, opts: "NewtonOptions"):
    """One Newton direction (residual + Jacobian state + preconditioned
    Krylov solve) as a single jitted program with the form's tabulated
    tensors passed as arguments (closed-over tables become XLA constants,
    which inflates compile time).  Cached on the form per option set.
    Returns the direction ``c``; the host loop applies ``x - d*c`` so it
    can backtrack on a residual increase without re-solving.

    GMG preconditioners (multigrid.GMG.as_preconditioner) participate via
    the fused protocol: their level data is the extra ``pdata`` argument.
    """
    fp = getattr(opts.preconditioner, "fused_precond", None)
    key = (
        "newton_dir", opts.lin_solver, opts.lin_tol, opts.lin_maxiter,
        id(fp) if fp is not None else opts.preconditioner,
    )

    def step(tables, ess, x, b, fields, pdata):
        r = form.mult_raw(tables, ess, x, fields) - b
        r = jnp.where(ess, 0.0, r)
        state = form.grad_state_raw(tables, x, fields)
        if opts.lin_solver == "schur":
            # element-exact elimination for L2 latents; lumped-Schur
            # block preconditioner + MINRES for H1 latents (ex5)
            lumped = form.spaces[-1].fe_type != "L2"
            return _schur_solve_traced(
                form, tables, ess, state, r, opts.lin_tol,
                opts.lin_maxiter, lumped=lumped, fp=fp, pdata=pdata,
            )
        mv = lambda v: form.grad_mult_raw(tables, ess, state, v)  # noqa: E731
        M = None
        if fp is not None:
            d0 = form.grad_diag_raw(tables, ess, state)
            if getattr(fp, "nonlinear", False):
                # re-linearize coarse GMG levels at the current iterate
                # (traced, once per direction) — without this the V-cycle
                # preconditions a nonlinear energy with its Hessian at 0
                pdata = fp.fused_refresh(pdata, x, fields)
            M = lambda v: fp.fused_apply(pdata, state, d0, v)  # noqa: E731
        elif opts.preconditioner == "jacobi":
            d = jnp.abs(form.grad_diag_raw(tables, ess, state))
            safe = jnp.where(d < 1e-30, 1.0, d)
            M = lambda v: v / safe  # noqa: E731
        return _KRYLOV[opts.lin_solver](
            mv, r, M=M, tol=opts.lin_tol, maxiter=opts.lin_maxiter
        )

    return form._jit(key, step)


def _apply_step(form, x, c, b, fields, norm, opts):
    """``x - d*c`` with a backtracking safeguard: halve ``d`` (up to 4
    times) while the step increases the residual norm, and keep the least-
    bad candidate if every damping fails.  Plain Newton accepts every
    step; this only engages on steps that would grow ``||r||`` — e.g. a
    noise-amplified direction from a nearly-singular LVPP Schur system —
    and costs one extra residual evaluation per Newton iteration.
    """
    with profiling.phase("newton/line_search"):
        return _apply_step_impl(form, x, c, b, fields, norm, opts)


def _apply_step_impl(form, x, c, b, fields, norm, opts):
    def rnorm(xn):
        rn = form.mult(xn, fields) - b
        return float(jnp.linalg.norm(jnp.where(form.ess_mask, 0.0, rn)))

    d = opts.damping
    best_x, best_n = None, np.inf
    for _ in range(5):
        xn = x - d * c
        nn = rnorm(xn)
        if nn <= norm * (1.0 + 1e-10):
            return xn
        if nn < best_n:
            best_x, best_n = xn, nn
        d *= 0.5
    if best_x is None:
        # every damped candidate produced a NaN residual (e.g. a neo-
        # Hookean direction inverting elements at all dampings); keep the
        # current iterate so the Newton loop reports non-convergence
        # instead of propagating None/NaN into the next mult.
        return x
    return best_x


def newton(form, x0, b=None, fields=None, opts: NewtonOptions | None = None):
    """MFEM-NewtonSolver-style damped Newton on ``form.mult(x) = b``.

    Host-side outer loop (like the reference's NewtonSolver::Mult); each
    residual/Jacobian/Krylov evaluation is a jit-compiled device program.
    """
    opts = opts or NewtonOptions()
    fields = fields or {}
    x = jnp.asarray(x0)
    if b is None:
        b = jnp.zeros_like(x)
    else:
        b = jnp.asarray(b, dtype=x.dtype)

    fp = getattr(opts.preconditioner, "fused_precond", None)
    fused = (
        isinstance(opts.lin_solver, str)
        and opts.lin_solver in _KRYLOV
        and (opts.preconditioner in (None, "jacobi") or fp is not None)
    )
    if opts.lin_solver == "schur":
        # the Schur reduction has its own internal Jacobi; it requires a
        # 2-block (primal, latent-last) system with an L2 latent and no
        # essential dofs on the latent block
        off = form.offsets
        if len(off) != 3:
            raise ValueError("lin_solver='schur' needs a 2-block system")
        if not (hasattr(form, "integrators")
                or hasattr(form, "schur_arrays_raw")):
            raise ValueError(
                "lin_solver='schur' needs element-block access "
                "(BlockNonlinearForm or ShardedForm)"
            )
        # validate on the CANONICAL mask (sharded/halo wrappers carry the
        # serial form at .form; the halo ess_mask is in distributed
        # layout where off[] does not apply)
        base = getattr(form, "form", form)
        if bool(np.any(np.asarray(base.ess_mask)[int(off[1]):])):
            raise ValueError(
                "lin_solver='schur' requires no essential dofs on the "
                "latent block"
            )
        fused = True
    chunked = opts.lin_solver == "schur" and opts.lin_chunk is not None
    step = _fused_newton_step(form, opts) if fused and not chunked else None
    pdata = fp.fused_pdata() if fp is not None else ()

    hist = []
    lin_iters = []
    norm0 = None
    it = 0
    converged = False
    norm = np.inf
    stalled = 0
    for it in range(opts.max_iter + 1):
        with profiling.phase("newton/residual"):
            r = form.mult(x, fields) - b
            r = jnp.where(form.ess_mask, 0.0, r)
            norm = float(jnp.linalg.norm(r))
        hist.append(norm)
        if norm0 is None:
            norm0 = norm
        if opts.verbose:
            print(f"  newton it {it:3d}: ||r|| = {norm:.6e}", flush=True)
        if norm <= max(opts.rel_tol * norm0, opts.abs_tol):
            converged = True
            break
        if it == opts.max_iter:
            break
        # Stagnation break: when abs_tol sits below the floor the
        # direction solver can reach (e.g. f32 arithmetic),
        # every further iteration burns a full direction solve for no
        # progress.  A floored Newton bounces at ratio ~1.0 +- noise;
        # legitimately slow damped phases contract by clearly more than
        # 5%.  Two consecutive <5% reductions => floored: return
        # non-converged and let the caller (PGSolver.newton_accept)
        # decide.
        stalled = stalled + 1 if it > 0 and norm > 0.95 * hist[-2] else 0
        if opts.stall_iters is not None and stalled >= opts.stall_iters:
            break
        if chunked:
            with profiling.phase("newton/direction"):
                c, li = _schur_dir_chunked(
                    form, opts, fp, x, b, fields, pdata)
            lin_iters.append(li)
            xn = _apply_step(form, x, c, b, fields, norm, opts)
            if xn is x:
                break  # every damped candidate was NaN — no progress possible
            x = xn
            continue
        if fused:
            with profiling.phase("newton/direction"):
                c = step(form._tables(), form.ess_mask, x, b, fields,
                         pdata)
                jax.block_until_ready(c)
            xn = _apply_step(form, x, c, b, fields, norm, opts)
            if xn is x:
                break
            x = xn
            continue
        state = form.grad_state(x, fields)
        if opts.lin_solver == "dense":
            A = form.assemble_dense(state)
            r_np = np.asarray(r)
            try:
                c_np = np.linalg.solve(A, r_np)
            except np.linalg.LinAlgError:
                c_np = np.full_like(r_np, np.nan)
            cmax = float(np.max(np.abs(c_np))) if c_np.size else 0.0
            rmax = float(np.max(np.abs(r_np))) + 1e-300
            if not np.all(np.isfinite(c_np)) or cmax > 1e12 * rmax:
                # machine-singular LU (e.g. dof-PG with saturated E*''
                # rows, kappa ~ 1e14+): the raw direction is NaN or
                # astronomically scaled and would NaN the line search.
                # Use the minimum-norm least-squares direction instead —
                # near-null components (the saturated latent nodes the
                # outer PG loop doesn't need resolved) are frozen, the
                # well-conditioned subspace still gets its Newton step.
                c_np = np.linalg.lstsq(A, r_np, rcond=1e-10)[0]
            c = jnp.asarray(c_np)
        elif callable(opts.lin_solver):
            c = opts.lin_solver(form, state, r)
        else:
            mv = partial(form.grad_mult, state)
            M = _make_precond(form, state, opts.preconditioner)
            solve = _KRYLOV[opts.lin_solver]
            c = solve(
                mv, r, M=M, tol=opts.lin_tol, maxiter=opts.lin_maxiter
            )
        xn = _apply_step(form, x, c, b, fields, norm, opts)
        if xn is x:
            break
        x = xn

    return NewtonResult(
        x=x,
        converged=converged,
        iterations=it,
        final_norm=norm,
        history=hist,
        lin_iters=lin_iters,
    )
