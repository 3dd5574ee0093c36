"""Obstacle problem via LVPP proximal Galerkin — reference ex4
(/root/reference/ex4.cpp): minimize 0.5||grad u||² - (f, u) subject to
0 <= u <= 0.5, via the FermiDirac mirror map on mixed H1(p+1) x L2(p-1)
spaces; outer PG loop with the lambda-increment stopping rule."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax.numpy as jnp

from .. import mesh as M
from ..ad import ADFunction
from ..adeval import ADEval
from ..fespace import FESpace, L2
from ..forms import BlockNonlinearForm, LinearForm
from ..integrator import ADBlockIntegrator
from ..pg import ADPGFunctional, FermiDiracEntropy, PGSolver, PGStepSizeRule
from ..solvers import NewtonOptions


class ObstacleEnergy(ADFunction):
    """0.5 ||grad u||²; input x = [u, grad u] (ex4.cpp:15-28)."""

    def __init__(self, dim: int):
        super().__init__(dim + 1)

    def energy(self, x, p):
        g = x[1:]
        return 0.5 * jnp.dot(g, g)


def load_fn(x):
    return 2 * np.pi**2 * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])


def load_fn_3d(x):
    return (3 * np.pi**2 * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])
            * np.sin(np.pi * x[2]))


@dataclass
class Problem:
    mesh: object
    primal_space: FESpace
    latent_space: FESpace
    form: BlockNonlinearForm
    rhs: object
    pg: ADPGFunctional
    ir_order: int


def build(order: int = 2, ref_levels: int = 3, n0: int = 10,
          lower: float = 0.0, upper: float = 0.5, dim: int = 2,
          geom: str | None = None) -> Problem:
    """dim=3 is a superset of the reference (ex4.cpp:78 is 2D-only):
    the whole LVPP stack — mixed H1xL2 block integrator, Schur
    elimination, hp-GMG — is dimension-agnostic, so the hex-mesh
    (or, with geom="tet", tetrahedral-mesh) obstacle problem comes
    for free."""
    from ..quadrature import TETRAHEDRON

    if dim == 3:
        g = TETRAHEDRON if geom in ("tet", TETRAHEDRON) else None
        m = (M.make_cartesian_3d(n0, n0, n0, geom=g) if g
             else M.make_cartesian_3d(n0, n0, n0)).uniform_refine(ref_levels)
    else:
        m = M.make_cartesian_2d(n0, n0).uniform_refine(ref_levels)
    dim = m.dim
    h1 = FESpace(m, order + 1)
    l2 = FESpace(m, order - 1, L2)

    entropy = FermiDiracEntropy(lower, upper)
    pg = ADPGFunctional(ObstacleEnergy(dim), entropy, l2)

    form = BlockNonlinearForm([h1, l2])
    ir_order = 3 * order + 3  # ex4.cpp:104
    form.add_domain_integrator(
        ADBlockIntegrator(
            pg,
            [h1, l2],
            [ADEval.VALUE | ADEval.GRAD, ADEval.VALUE],
            ir_order=ir_order,
        )
    )
    form.set_essential_bc([np.ones(m.max_bdr_attribute()), None])

    rhs = np.zeros(form.ndof)
    b = LinearForm(h1, load_fn_3d if dim == 3 else load_fn).assemble()
    b[np.asarray(h1.boundary_dofs())] = 0.0
    rhs[: h1.ndof] = b
    return Problem(
        mesh=m, primal_space=h1, latent_space=l2, form=form,
        rhs=jnp.asarray(rhs), pg=pg, ir_order=ir_order,
    )


def build_dofpg(order: int = 2, ref_levels: int = 3, n0: int = 10,
                lower: float = 0.0, upper=0.5, dim: int = 2,
                mesh=None) -> Problem:
    """DOF-level PG variant (reference dof_pg.hpp:9-231): the entropy
    coupling acts at the H1 nodal points, dual space = L2 of the SAME
    order (equal element dof count, dof_pg.hpp:46-48).  ``upper`` may be
    a float or a Coefficient — a GridFunctionCoefficient realizes the
    spatially-varying box bound of pg.hpp:281-322 (supply its dof vector
    through the solver's ``fields``)."""
    from ..dof_pg import DofPGIntegrator

    m = mesh
    if m is None:
        if dim == 3:
            m = M.make_cartesian_3d(n0, n0, n0).uniform_refine(ref_levels)
        else:
            m = M.make_cartesian_2d(n0, n0).uniform_refine(ref_levels)
    dim = m.dim
    h1 = FESpace(m, order + 1)
    dual = FESpace(m, order + 1, L2)

    entropy = FermiDiracEntropy(lower, upper)
    intg = DofPGIntegrator(
        ObstacleEnergy(dim), [h1], [ADEval.VALUE | ADEval.GRAD],
        [dual], [entropy], ir_order=3 * order + 3,
    )
    form = BlockNonlinearForm([h1, dual])
    form.add_domain_integrator(intg)
    form.set_essential_bc([np.ones(m.max_bdr_attribute()), None])

    rhs = np.zeros(form.ndof)
    b = LinearForm(h1, load_fn_3d if dim == 3 else load_fn).assemble()
    b[np.asarray(h1.boundary_dofs())] = 0.0
    rhs[: h1.ndof] = b
    return Problem(
        mesh=m, primal_space=h1, latent_space=dual, form=form,
        rhs=jnp.asarray(rhs), pg=None, ir_order=3 * order + 3,
    )


def solve_dofpg(
    order: int = 2,
    ref_levels: int = 2,
    rule_type: int = PGStepSizeRule.CONSTANT,
    alpha0: float = 1.0,
    max_alpha: float = 1e4,
    ratio: float = 1.0,
    ratio2: float = 1.0,
    max_pg_iter: int = 100,
    tol: float = 1e-8,
    verbose: bool = False,
    n0: int = 10,
    lin_maxiter: int = 2000,
    dim: int = 2,
    spatial_bound: bool = False,
    lin_solver: str = "minres",
):
    """LVPP outer loop on the dof-PG obstacle form.  ``spatial_bound``
    runs the pg.hpp:281-322 scenario: upper bound 0.3 + 0.2 x as a
    GridFunction-backed entropy parameter."""
    from ..coefficients import GridFunctionCoefficient

    fields = {}
    if dim == 3:
        m = M.make_cartesian_3d(n0, n0, n0).uniform_refine(ref_levels)
    else:
        m = M.make_cartesian_2d(n0, n0).uniform_refine(ref_levels)
    upper = 0.5
    if spatial_bound:
        bspace = FESpace(m, 1)
        upper = GridFunctionCoefficient(bspace, "ub_field")
        fields["ub_field"] = jnp.asarray(
            bspace.project(lambda x: 0.3 + 0.2 * x[0])
        )
    pb = build_dofpg(order, ref_levels, n0=n0, upper=upper, dim=dim,
                     mesh=m)

    rule = PGStepSizeRule(rule_type, alpha0, max_alpha, ratio, ratio2)
    nopts = NewtonOptions(
        abs_tol=1e-9, rel_tol=0.0, max_iter=20, lin_solver=lin_solver,
        lin_tol=1e-12, lin_maxiter=lin_maxiter,
        preconditioner=None if lin_solver == "dense" else "jacobi",
    )
    solver = PGSolver(
        pb.form, rule, latent_block=1, latent_space=pb.latent_space,
        newton_opts=nopts, max_iter=max_pg_iter, tol=tol, verbose=verbose,
        newton_accept=1e-5,
    )
    res = solver.solve(jnp.zeros(pb.form.ndof), pb.rhs, fields=fields)
    return res, pb


def _primal_gmg(order: int, ref_levels: int, n0: int, dim: int = 2):
    """hp-GMG on the primal diffusion block (H1(order+1)): order-p fine
    level p-coarsens to Q1, then geometric coarsening to the n0 mesh.
    Used additively inside the condensed Schur solve (PGSchurGMG)."""
    from ..multigrid import GMG, PGSchurGMG, build_hp_hierarchy
    from ..forms import NonlinearForm
    from ..ad import DiffusionEnergy

    def build_fn(n, p):
        m = (M.make_cartesian_3d(n, n, n) if dim == 3
             else M.make_cartesian_2d(n, n))
        fes = FESpace(m, p)
        f = NonlinearForm(fes)
        f.add_ad_integrator(DiffusionEnergy(m.dim), ADEval.GRAD)
        f.set_essential_bc([np.ones(m.max_bdr_attribute())])
        return f

    forms = build_hp_hierarchy(build_fn, n0, ref_levels + 1, order + 1)
    return PGSchurGMG(GMG(forms))


def solve(
    order: int = 2,
    ref_levels: int = 3,
    rule_type: int = PGStepSizeRule.CONSTANT,
    alpha0: float = 1.0,
    max_alpha: float = 1e4,
    ratio: float = 1.0,
    ratio2: float = 1.0,
    lin_solver: str = "schur",
    max_pg_iter: int = 100,
    tol: float = 1e-10,
    verbose: bool = False,
    n0: int = 10,
    gmg: bool = True,
    lin_maxiter: int = 2000,
    dim: int = 2,
    geom: str | None = None,
    callback=None,
):
    """ex4: build the problem and run the LVPP loop.  ``callback(it, x,
    lam)`` is passed to ``PGSolver.solve`` (called after every outer
    iteration)."""
    pb = build(order, ref_levels, n0=n0, dim=dim, geom=geom)
    rule = PGStepSizeRule(rule_type, alpha0, max_alpha, ratio, ratio2)
    precond = None
    if lin_solver == "schur" and gmg and geom is None:
        precond = _primal_gmg(order, ref_levels, n0,
                              dim=dim).as_preconditioner()
    elif lin_solver not in ("dense", "schur"):
        precond = "jacobi"
    nopts = NewtonOptions(
        abs_tol=1e-9, rel_tol=0.0, max_iter=20, lin_solver=lin_solver,
        # a GMG+active-set-Jacobi solve that hasn't converged by 2000 CG
        # iterations is at its floor anyway (the windowed exit usually
        # fires first).
        lin_tol=1e-13, lin_maxiter=lin_maxiter,
        preconditioner=precond,
    )
    solver = PGSolver(
        pb.form, rule, latent_block=1, latent_space=pb.latent_space,
        newton_opts=nopts, max_iter=max_pg_iter, tol=tol, verbose=verbose,
        # bounded-budget Krylov directions can stagnate Newton just
        # above abs_tol (1e-9); accept and let the PG loop correct
        newton_accept=1e-5,
    )
    x0 = jnp.zeros(pb.form.ndof)
    res = solver.solve(x0, pb.rhs, callback=callback)
    return res, pb
