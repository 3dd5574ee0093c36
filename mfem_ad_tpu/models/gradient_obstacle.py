"""Gradient-constrained obstacle problem via LVPP — reference ex5
(/root/reference/ex5.cpp): minimize 0.5||grad u||² - (f, u) subject to
||grad u|| <= φ(x) = 0.1 + 0.2x + 0.4y, via the Hellinger mirror map on
H1(p) x H1(p-1)^dim spaces over a triangle mesh."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from .. import mesh as M
from ..ad import ADFunction
from ..adeval import ADEval
from ..fespace import FESpace
from ..forms import BlockNonlinearForm, LinearForm
from ..integrator import ADBlockIntegrator
from ..pg import ADPGFunctional, HellingerEntropy, PGSolver, PGStepSizeRule
from ..quadrature import TRIANGLE
from ..solvers import NewtonOptions


class GradientObstacleEnergy(ADFunction):
    """0.5 ||grad u||²; input x = grad u (ex5.cpp:15-22)."""

    def __init__(self, dim: int):
        super().__init__(dim)

    def energy(self, x, p):
        return 0.5 * jnp.dot(x, x)


def load_fn(x):
    return 15.0 * np.sin(np.pi * x[0]) ** 2


def bound_fn(x):
    return 0.1 + 0.2 * x[0] + 0.4 * x[1]  # ex5.cpp:114-115


@dataclass
class Problem:
    mesh: object
    primal_space: FESpace
    latent_space: FESpace
    form: BlockNonlinearForm
    rhs: object
    pg: ADPGFunctional


def _primal_gmg(order: int, ref_levels: int, n0: int):
    """hp-GMG on the primal diffusion block of ex5: order-p fine space on
    the structured triangle mesh p-coarsens to P1 on the same mesh, then
    geometric coarsening to the n0 mesh (triangle dof grids are
    lexicographic, see fespace 'h1t').  Used as the S~-approximation
    inside the lumped-Schur block preconditioner — the role BoomerAMG
    plays in the reference's PGPreconditioner (pg.hpp:388-400)."""
    from ..ad import DiffusionEnergy
    from ..forms import NonlinearForm
    from ..multigrid import GMG, PGSchurGMG, build_hp_hierarchy

    def build_fn(n, p):
        m = M.make_cartesian_2d(n, n, TRIANGLE)
        fes = FESpace(m, p)
        f = NonlinearForm(fes)
        f.add_ad_integrator(DiffusionEnergy(m.dim), ADEval.GRAD)
        f.set_essential_bc([np.ones(m.max_bdr_attribute())])
        return f

    forms = build_hp_hierarchy(build_fn, n0, ref_levels + 1, order)
    return PGSchurGMG(GMG(forms))


def build(order: int = 2, ref_levels: int = 3, n0: int = 10) -> Problem:
    if order < 2:
        raise ValueError("ex5 requires order >= 2 (latent H1 space order-1)")
    m = M.make_cartesian_2d(n0, n0, TRIANGLE).uniform_refine(ref_levels)
    dim = m.dim
    primal = FESpace(m, order)
    latent = FESpace(m, order - 1, vdim=dim)

    entropy = HellingerEntropy(dim, bound_fn)
    pg = ADPGFunctional(GradientObstacleEnergy(dim), entropy, latent)

    form = BlockNonlinearForm([primal, latent])
    form.add_domain_integrator(
        ADBlockIntegrator(
            pg,
            [primal, latent],
            [ADEval.GRAD, ADEval.VALUE | ADEval.VECTOR],
        )
    )
    form.set_essential_bc([np.ones(m.max_bdr_attribute()), None])

    rhs = np.zeros(form.ndof)
    b = LinearForm(primal, load_fn).assemble()
    b[np.asarray(primal.boundary_dofs())] = 0.0
    rhs[: primal.ndof] = b
    return Problem(
        mesh=m, primal_space=primal, latent_space=latent, form=form,
        rhs=jnp.asarray(rhs), pg=pg,
    )


def solve(
    order: int = 2,
    ref_levels: int = 3,
    rule_type: int = PGStepSizeRule.CONSTANT,
    alpha0: float = 1.0,
    max_alpha: float = 1e6,
    ratio: float = 1.0,
    ratio2: float = 1.0,
    lin_solver: str = "schur",
    max_pg_iter: int = 100,
    tol: float = 1e-8,
    verbose: bool = False,
    n0: int = 10,
    lin_maxiter: int = 2000,
    gmg: bool = True,
    lin_tol: float = 1e-10,
    newton_abs_tol: float = 1e-11,
):
    pb = build(order, ref_levels, n0=n0)
    rule = PGStepSizeRule(rule_type, alpha0, max_alpha, ratio, ratio2)
    precond = None
    if lin_solver == "schur" and gmg:
        precond = _primal_gmg(order, ref_levels, n0).as_preconditioner()
    elif lin_solver not in ("dense", "schur"):
        precond = "jacobi"
    nopts = NewtonOptions(
        # The lambda stopping norm is INT |lam - lam_prev|, and every
        # direction error dpsi injects dpsi/alpha of lambda noise, so the
        # achievable lambda floor is set directly by the direction
        # accuracy: at ref 2, lin_tol=1e-8 floors
        # |lam diff| at ~1e-6 (100 PG its bouncing, never < tol), while
        # lin_tol ~1e-6 DIVERGES outright at alpha >= 5e5.  The LDU-FGMRES
        # direction (solvers._ldu_fgmres) converges ~1 decade/iteration,
        # so 2 extra decades of accuracy cost only ~2 outer iterations —
        # tight directions are cheap now, unlike the round-2 MINRES path.
        abs_tol=newton_abs_tol, rel_tol=0.0, max_iter=20,
        lin_solver=lin_solver,
        lin_tol=lin_tol, lin_maxiter=lin_maxiter,
        preconditioner=precond,
    )
    solver = PGSolver(
        pb.form, rule, latent_block=1, latent_space=pb.latent_space,
        newton_opts=nopts, max_iter=max_pg_iter, tol=tol, verbose=verbose,
        # bounded-budget Krylov directions can stagnate Newton just
        # above abs_tol (1e-9); accept and let the PG loop correct
        newton_accept=1e-5,
    )
    res = solver.solve(jnp.zeros(pb.form.ndof), pb.rhs)
    return res, pb
