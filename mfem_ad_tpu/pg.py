"""Proximal Galerkin / LVPP layer: entropies, PG functional, outer loop.

JAX redesign of the reference's src/pg.{hpp,cpp}:

- ``PGStepSizeRule``  — step-size schedules (pg.hpp:10-34, pg.cpp:4-54).
- entropy zoo        — dual (conjugate) entropies E* as ADFunctions with
  numerically stable softplus/logsumexp forms (pg.hpp:259-376).
- ``ADPGFunctional`` — the LVPP augmented energy
  L(u, psi) = f(u) + (1/alpha) (u·(psi - psi_k) - E*(psi))  (pg.hpp:60-66,
  AD_IMPL at pg.hpp:193-213).  alpha and psi_k enter as runtime fields
  (traced arrays), so each outer iteration reuses the compiled kernels.
- ``ADLambdaPGFunctional`` — the lambda-variable variant (pg.hpp:216-243).
- ``PGSolver``       — the outer proximal-point fixed-point loop with the
  lambda-increment stopping rule of ex4.cpp:183-219.
- ``pg_block_preconditioner`` — SPD block-diagonal preconditioner for the
  (u, psi) saddle Jacobian, mirroring PGPreconditioner's structure
  (stiffness block + entropy-weighted mass block, pg.hpp:378-504) with
  Jacobi in place of BoomerAMG.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from .ad import ADFunction, admax
from .coefficients import GridFunctionCoefficient, ScalarFieldCoefficient
from .fespace import FESpace
from .solvers import NewtonOptions, newton
from .utils import profiling


# ---------------------------------------------------------------------------
# Step-size rules (pg.hpp:10-34, pg.cpp:4-54)
# ---------------------------------------------------------------------------


class PGStepSizeRule:
    CONSTANT, POLY, EXP, DOUBLE_EXP = range(4)

    def __init__(self, rule_type=0, alpha0=1.0, max_alpha=1e6, ratio=-1.0,
                 ratio2=-1.0):
        self.rule_type = rule_type
        self.alpha0 = alpha0
        self.max_alpha = max_alpha
        self.ratio = ratio
        self.ratio2 = ratio2

    def get(self, it: int) -> float:
        if self.rule_type == self.CONSTANT:
            a = self.alpha0
        elif self.rule_type == self.POLY:
            a = self.alpha0 * (it + 1.0) ** self.ratio
        elif self.rule_type == self.EXP:
            a = self.alpha0 * self.ratio**it
        elif self.rule_type == self.DOUBLE_EXP:
            a = self.alpha0 * self.ratio ** (self.ratio2**it)
        else:
            raise ValueError(f"invalid rule type {self.rule_type}")
        return float(min(a, self.max_alpha))


# ---------------------------------------------------------------------------
# Entropies (pg.hpp:37-44, :259-376)
# ---------------------------------------------------------------------------


class ADEntropy(ADFunction):
    """Marker base for dual (conjugate) entropy functions E*."""


class ShannonEntropy(ADEntropy):
    """E*(psi) = sign*exp(sign*psi) + bound*psi — one-sided bound
    (pg.hpp:259-278).  sign=+1: [lower, inf); sign=-1: (-inf, upper]."""

    def __init__(self, bound, sign: int = 1):
        super().__init__(1)
        assert sign in (1, -1)
        self.sign = sign
        self.add_parameter("bound", bound)

    def energy(self, x, p):
        s = self.sign
        return s * jnp.exp(x[0] * s) + p["bound"][0] * x[0]


class FermiDiracEntropy(ADEntropy):
    """E*(psi) = softplus(scale*psi) + shift*psi with box bounds
    [lower, upper]; shift = lower, scale = upper - lower (pg.hpp:281-322,
    including the numerically stable softplus branch :308-321)."""

    def __init__(self, lower_bound, upper_bound):
        super().__init__(1)
        self.add_parameter("lower", lower_bound)
        self.add_parameter("upper", upper_bound)

    def energy(self, x, p):
        shift = p["lower"][0]
        scale = p["upper"][0] - shift
        return jax.nn.softplus(x[0] * scale) + shift * x[0]


class HellingerEntropy(ADEntropy):
    """E*(psi) = sqrt(1 + scale^2 ||psi||^2) — gradient-norm bound
    ||grad u|| <= bound (pg.hpp:324-342); scale = the (possibly spatial)
    bound coefficient."""

    def __init__(self, dim: int, bound):
        super().__init__(dim)
        self.add_parameter("bound", bound)

    def energy(self, x, p):
        s = p["bound"][0]
        return jnp.sqrt(1.0 + jnp.dot(x, x) * (s * s))


class SimplexEntropy(ADEntropy):
    """E*(psi) = scale * logsumexp(psi) — simplex constraint x_i >= 0,
    sum x_i = bound (pg.hpp:347-376).  Uses the same max-shifted stable
    form as the reference (with subgradient-averaging max)."""

    def __init__(self, n_input: int, bound):
        super().__init__(n_input)
        self.add_parameter("bound", bound)

    def energy(self, x, p):
        maxval = x[0]
        for i in range(1, self.n_input):
            maxval = admax(maxval, x[i])
        return p["bound"][0] * (
            maxval + jnp.log(jnp.sum(jnp.exp(x - maxval)))
        )


# ---------------------------------------------------------------------------
# PG functionals (pg.hpp:67-243)
# ---------------------------------------------------------------------------


class ADPGFunctional(ADFunction):
    """LVPP augmented energy over the stacked input [x_f | psi_0 | psi_1 ...].

    L = f(x) + (1/alpha) * sum_i [ x[primal_idx_i : +m_i]·(psi_i - psi_k_i)
                                   - E*_i(psi_i) ]

    Each entropy i couples to the primal slice starting at ``primal_idx[i]``
    (pg.hpp:72-75).  Runtime fields:
      - ``alpha``        scalar PG step (SetAlpha, pg.hpp:177-180)
      - ``latent_k{i}``  frozen latent dof vector on ``latent_spaces[i]``
                         (the GridFunction parameter, pg.hpp:106-111).
    """

    def __init__(self, f: ADFunction, entropies, latent_spaces, primal_idx=None):
        if isinstance(entropies, ADEntropy):
            entropies = [entropies]
        if latent_spaces is None or isinstance(latent_spaces, FESpace):
            latent_spaces = [latent_spaces] * len(entropies)
        sizes = [e.n_input for e in entropies]
        super().__init__(f.n_input + sum(sizes))
        self.f = f
        self.entropies = list(entropies)
        self.entropy_size = sizes
        if primal_idx is None:
            primal_idx = [0] * len(entropies)
        self.primal_idx = list(primal_idx)
        self.dual_idx = list(
            f.n_input + np.concatenate([[0], np.cumsum(sizes)[:-1]])
        )
        for i, (pi, m) in enumerate(zip(self.primal_idx, sizes)):
            if f.n_input < pi + m:
                raise ValueError(
                    "ADPGFunctional: primal_idx + entropy size exceeds "
                    f"f.n_input for entropy {i}"
                )
        # merged parameter namespace
        self.params = dict(f.params)
        for i, e in enumerate(entropies):
            for k, c in e.params.items():
                self.params[f"entropy{i}_{k}"] = c
        for i, sp in enumerate(latent_spaces):
            if sp is not None:
                self.params[f"latent_k{i}"] = GridFunctionCoefficient(
                    sp, f"latent_k{i}"
                )
        self.params["alpha"] = ScalarFieldCoefficient("alpha")

    def _entropy_params(self, i, p):
        pre = f"entropy{i}_"
        return {k[len(pre):]: v for k, v in p.items() if k.startswith(pre)}

    def energy(self, x_psi, p):
        x = x_psi[: self.f.n_input]
        alpha = p["alpha"][0]
        cross = 0.0
        dual_sum = 0.0
        for i, e in enumerate(self.entropies):
            m = self.entropy_size[i]
            psi = x_psi[self.dual_idx[i] : self.dual_idx[i] + m]
            psi_k = p[f"latent_k{i}"]
            xi = jax.lax.dynamic_slice(x, (self.primal_idx[i],), (m,))
            cross = cross + jnp.dot(xi, psi - psi_k)
            dual_sum = dual_sum + e.energy(psi, self._entropy_params(i, p))
        return self.f.energy(x, p) + (cross - dual_sum) / alpha


class ADLambdaPGFunctional(ADPGFunctional):
    """lambda-variable variant (pg.hpp:216-243):
    L = f(x) + x·lambda - E*(psi_k + alpha*lambda)/alpha."""

    def energy(self, x_lam, p):
        x = x_lam[: self.f.n_input]
        alpha = p["alpha"][0]
        cross = 0.0
        dual_sum = 0.0
        for i, e in enumerate(self.entropies):
            m = self.entropy_size[i]
            lam = x_lam[self.dual_idx[i] : self.dual_idx[i] + m]
            psi_k = p[f"latent_k{i}"]
            psi = psi_k + alpha * lam
            xi = jax.lax.dynamic_slice(x, (self.primal_idx[i],), (m,))
            cross = cross + jnp.dot(xi, lam)
            dual_sum = dual_sum + e.energy(psi, self._entropy_params(i, p))
        return self.f.energy(x, p) + cross - dual_sum / alpha


# ---------------------------------------------------------------------------
# Block preconditioner and outer solver
# ---------------------------------------------------------------------------


def pg_block_preconditioner(form, state):
    """SPD block-diagonal preconditioner |diag(J)|^{-1} for MINRES on the
    (u, psi) saddle system.  Structurally mirrors PGPreconditioner
    (pg.hpp:378-504): a stiffness-block solve and a (negated)
    entropy-weighted mass block — realized here as absolute-value Jacobi,
    the AMG-free substitute."""
    d = form.grad_diag(state)
    safe = jnp.where(jnp.abs(d) < 1e-30, 1.0, jnp.abs(d))
    return lambda x: x / safe


@dataclass
class PGResult:
    x: object
    converged: bool
    iterations: int
    lambda_diff: float
    newton_iters: list
    lam: object


class PGSolver:
    """Outer LVPP proximal-point loop (ex4.cpp:183-219 / ex5.cpp:172-212).

    Each iteration freezes psi_k <- psi, solves the saddle system with
    Newton, forms lambda = (psi - psi_k)/alpha and stops when the L1 norm
    of (lambda - lambda_prev) drops below ``tol``.
    """

    def __init__(
        self,
        form,
        rule: PGStepSizeRule,
        latent_block: int,
        latent_space: FESpace,
        newton_opts: NewtonOptions | None = None,
        max_iter: int = 100,
        tol: float = 1e-10,
        verbose: bool = False,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 1,
        newton_accept: float = 0.0,
    ):
        self.form = form
        self.rule = rule
        self.latent_block = latent_block
        self.latent_space = latent_space
        self.newton_opts = newton_opts or NewtonOptions(
            abs_tol=1e-9, rel_tol=0.0, max_iter=20
        )
        self.max_iter = max_iter
        self.tol = tol
        self.verbose = verbose
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        # Inexact proximal point: when the inner Newton stagnates ABOVE
        # its tolerance but below ``newton_accept`` (absolute residual
        # norm), continue the outer loop instead of aborting.  The PG
        # iteration is self-correcting (each step re-solves against the
        # new psi_k, so bounded inner errors perturb, not poison, the
        # fixed point); the reference aborts instead (ex4.cpp:191-195)
        # because MUMPS never leaves it with a stagnated inner solve,
        # while bounded-budget Krylov directions can stall at ~1e-6.
        self.newton_accept = newton_accept

    def solve(self, x0, rhs, fields=None, callback=None,
              resume: bool = False) -> PGResult:
        """Run the outer LVPP loop.  With ``checkpoint_path`` set, the state
        (x, lambda_prev, iteration) is saved every ``checkpoint_every``
        outer iterations; ``resume=True`` restarts from the latest one —
        an auxiliary the reference lacks entirely (SURVEY.md §5)."""
        from .norms import l1_norm

        fields = dict(fields or {})
        x = jnp.asarray(x0)
        off = self.form.offsets
        s = self.latent_block
        lam_prev = None
        lam = None
        lam_diff = np.inf
        newton_iters = []
        converged = False
        it = 0
        start_it = 0
        if resume and self.checkpoint_path is not None:
            import os

            from .utils.checkpoint import load_checkpoint

            final = (self.checkpoint_path
                     if self.checkpoint_path.endswith(".npz")
                     else self.checkpoint_path + ".npz")
            if os.path.exists(final):
                arrays, meta = load_checkpoint(self.checkpoint_path)
                x = jnp.asarray(arrays["x"])
                if "lam_prev" in arrays:
                    lam_prev = jnp.asarray(arrays["lam_prev"])
                if meta is not None and "iteration" in meta:
                    start_it = int(meta["iteration"]) + 1
                if self.verbose:
                    print(f"PG resume from iteration {start_it}",
                          flush=True)
        # distributed-layout (halo) forms: the latent block is extracted
        # through the canonical converter once per OUTER iteration (the
        # mirror state changes outside the Krylov hot loop; field vectors
        # stay replicated in halo mode, integrator.eval_params)
        if hasattr(self.form, "from_dist"):
            def latent_of(xv):
                xc = self.form.from_dist(np.asarray(xv))
                return jnp.asarray(xc[off[s] : off[s + 1]])
        else:
            def latent_of(xv):
                return xv[off[s] : off[s + 1]]

        for it in range(start_it, self.max_iter):
            t_it = time.perf_counter()
            alpha = self.rule.get(it)
            psik = latent_of(x)
            fields["alpha"] = jnp.asarray(alpha)
            fields["latent_k0"] = psik
            with profiling.phase("pg/newton"):
                res = newton(self.form, x, rhs, fields, self.newton_opts)
            newton_iters.append(res.iterations)
            if not res.converged:
                if res.final_norm <= self.newton_accept:
                    if self.verbose:
                        print(
                            f"PG it {it+1}: Newton stagnated at "
                            f"||r||={res.final_norm:.3e} <= accept "
                            f"{self.newton_accept:g}; continuing",
                            flush=True,
                        )
                else:
                    if self.verbose:
                        print(
                            f"PG it {it+1}: Newton FAILED after "
                            f"{res.iterations} its "
                            f"(||r||={res.final_norm:.3e})",
                            flush=True,
                        )
                    break
            x = res.x
            psi = latent_of(x)
            lam = (psi - psik) / alpha
            if lam_prev is not None:
                with profiling.phase("pg/lambda_norm"):
                    lam_diff = float(
                        l1_norm(self.latent_space, np.asarray(lam - lam_prev))
                    )
            if self.verbose:
                lin = (f" lin={sum(res.lin_iters)}"
                       if getattr(res, "lin_iters", None) else "")
                print(
                    f"PG it {it+1}: alpha={alpha:.4g} newton={res.iterations}"
                    f"{lin} |lam diff|_L1={lam_diff:.3e} "
                    f"[{time.perf_counter() - t_it:.1f}s]",
                    flush=True,
                )
            if callback is not None:
                callback(it, x, lam)
            if self.checkpoint_path is not None and (
                it % self.checkpoint_every == 0
            ):
                from .utils.checkpoint import save_checkpoint

                with profiling.phase("pg/checkpoint"):
                    arrays = {"x": np.asarray(x)}
                    if lam is not None:
                        arrays["lam_prev"] = np.asarray(lam)
                    save_checkpoint(
                        self.checkpoint_path, arrays,
                        meta={"iteration": it, "alpha": float(alpha),
                              "lam_diff": float(lam_diff)},
                    )
            if lam_diff < self.tol:
                converged = True
                break
            lam_prev = lam
        return PGResult(
            x=x,
            converged=converged,
            iterations=it + 1,
            lambda_diff=lam_diff,
            newton_iters=newton_iters,
            lam=lam,
        )
