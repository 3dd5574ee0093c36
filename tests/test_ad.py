"""AD core tests — the ex0 equivalent (reference ex0.cpp:100-162): gradients,
Hessians, vector Jacobians/Hessians vs hand-coded closed forms, plus the
built-in energy library and subgradient max/min tie handling."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mfem_ad_tpu as ft
from mfem_ad_tpu.ad import ADFunction, ADVectorFunction, admax, admin

X = np.array([0.5, 1.0, -1.0])


class MyADFunction(ADFunction):
    """f = sin(x0) exp(x1) + x2^3 (ex0.cpp:15-21)."""

    def energy(self, x, p):
        return jnp.sin(x[0]) * jnp.exp(x[1]) + x[2] ** 3


def hand_grad(x):
    return np.array(
        [
            np.cos(x[0]) * np.exp(x[1]),
            np.sin(x[0]) * np.exp(x[1]),
            3.0 * x[2] ** 2,
        ]
    )


def hand_hess(x):
    H = np.zeros((3, 3))
    H[0, 0] = -np.sin(x[0]) * np.exp(x[1])
    H[0, 1] = H[1, 0] = np.cos(x[0]) * np.exp(x[1])
    H[1, 1] = np.sin(x[0]) * np.exp(x[1])
    H[2, 2] = 6.0 * x[2]
    return H


def test_scalar_gradient_hessian():
    f = MyADFunction(3)
    assert np.allclose(f.gradient(X), hand_grad(X), atol=1e-12)
    assert np.allclose(f.hessian(X), hand_hess(X), atol=1e-12)


class MyADVecFunction(ADVectorFunction):
    """F = [sin(x0 x1), cos(x0 x1 x2)] (ex0.cpp:23-34)."""

    def function(self, x, p):
        return jnp.array([jnp.sin(x[0] * x[1]), jnp.cos(x[0] * x[1] * x[2])])


def test_vector_jacobian_hessian():
    f = MyADVecFunction(3, 2)
    x, y, z = X
    J = np.array(
        [
            [y * np.cos(x * y), x * np.cos(x * y), 0.0],
            [
                -y * z * np.sin(x * y * z),
                -x * z * np.sin(x * y * z),
                -x * y * np.sin(x * y * z),
            ],
        ]
    )
    assert np.allclose(f.gradient(X), J, atol=1e-12)
    H = np.asarray(f.hessian(X))  # [m, n, n]
    # component 0: sin(xy)
    H0 = np.array(
        [
            [-y * y * np.sin(x * y), np.cos(x * y) - x * y * np.sin(x * y), 0],
            [np.cos(x * y) - x * y * np.sin(x * y), -x * x * np.sin(x * y), 0],
            [0, 0, 0],
        ]
    )
    assert np.allclose(H[0], H0, atol=1e-12)


def test_admax_tie_subgradient():
    """At a tie the derivative is the average of both branches
    (ad_native.hpp:695-721)."""
    import jax

    g = jax.grad(lambda a: admax(a, 1.0))(1.0)
    assert np.isclose(float(g), 0.5)
    g2 = jax.grad(lambda a: admax(a, 1.0))(2.0)
    assert np.isclose(float(g2), 1.0)
    g3 = jax.grad(lambda a: admin(a, 1.0))(1.0)
    assert np.isclose(float(g3), 0.5)


def test_mass_energy():
    f = ft.MassEnergy(3)
    assert np.isclose(float(f(X)), 0.5 * np.dot(X, X))
    assert np.allclose(f.gradient(X), X)
    assert np.allclose(f.hessian(X), np.eye(3))


def test_diffusion_energy_variants():
    g = np.array([1.0, 2.0])
    f0 = ft.DiffusionEnergy(2)
    assert np.isclose(float(f0(g, {})), 0.5 * 5.0)
    # scalar K
    f1 = ft.DiffusionEnergy(2, 3.0)
    assert np.isclose(float(f1(g, {"K": jnp.array([3.0])})), 1.5 * 5.0)
    # vector K
    f2 = ft.DiffusionEnergy(2, np.array([2.0, 4.0]))
    assert np.isclose(
        float(f2(g, {"K": jnp.array([2.0, 4.0])})), 0.5 * (2 + 16)
    )
    # matrix K
    K = np.array([[2.0, 1.0], [1.0, 3.0]])
    f3 = ft.DiffusionEnergy(2, K)
    val = 0.5 * g @ K @ g
    assert np.isclose(float(f3(g, {"K": jnp.asarray(K.ravel())})), val)


def test_elasticity_energy():
    lam, mu = 2.0, 3.0
    f = ft.LinearElasticityEnergy(2, lam, mu)
    G = np.array([[1.0, 2.0], [0.5, -1.0]])
    p = {"lambda": jnp.array([lam]), "mu": jnp.array([mu])}
    sym = 0.5 * (G + G.T)
    expect = 0.5 * lam * np.trace(G) ** 2 + mu * np.sum(sym * sym)
    assert np.isclose(float(f(G.ravel(), p)), expect)
    # Hessian is constant (quadratic energy) and PSD-ish structure
    H = np.asarray(f.hessian(G.ravel(), p))
    assert np.allclose(H, H.T, atol=1e-12)


def test_lagrangian_and_al():
    obj = ft.MassEnergy(2)
    con = ADFunction(2, fn=lambda x, p: x[0] + x[1] - 1.0)
    lag = ft.Lagrangian(obj, 1).add_eq_constraint(con)
    x = np.array([1.0, 2.0, 3.0])  # [x0, x1, lambda]
    expect = 0.5 * 5.0 + 3.0 * (1.0 + 2.0 - 1.0)
    assert np.isclose(float(lag(x)), expect)
    lag.objective_mode()
    assert np.isclose(float(lag(x)), 2.5)
    lag.eq_constraint_mode(0)
    assert np.isclose(float(lag(x)), 2.0)

    al = ft.ALFunctional(obj).add_eq_constraint(con, target=0.5)
    al.set_multipliers([2.0])
    al.set_penalty(10.0)
    y = np.array([1.0, 2.0])
    cx = (1.0 + 2.0 - 1.0) - 0.5
    expect = 2.5 + cx * (2.0 + 0.5 * 10.0 * cx)
    assert np.isclose(float(al(y)), expect)


def test_diff_energy():
    base = ft.MassEnergy(2)
    f = ft.DiffEnergy(base, np.array([1.0, 1.0]))
    x = np.array([3.0, 2.0])
    p = {"target": jnp.array([1.0, 1.0])}
    assert np.isclose(float(f(x, p)), 0.5 * (4.0 + 1.0))


class TestLogdet:
    """Custom-JVP logdet/inv_t (the elementwise hyperelasticity form) must
    agree with jnp.log(jnp.linalg.det(.)) to machine precision through
    every AD composition the framework uses (grad, jacfwd∘grad,
    jacfwd∘jacfwd∘grad, jacrev∘grad)."""

    def _pair(self, d, seed):
        import numpy as np

        from mfem_ad_tpu.ad import logdet

        rng = np.random.default_rng(seed)
        F = jnp.asarray(np.eye(d) + 0.2 * rng.standard_normal((d, d)))
        f = lambda v: logdet(v.reshape(d, d))  # noqa: E731
        g = lambda v: jnp.log(jnp.linalg.det(v.reshape(d, d)))  # noqa: E731
        return F.ravel(), f, g

    @pytest.mark.parametrize("d", [2, 3])
    def test_matches_plain_to_third_order(self, d):
        v, f, g = self._pair(d, d)
        assert jnp.allclose(f(v), g(v), atol=1e-12)
        assert jnp.allclose(jax.grad(f)(v), jax.grad(g)(v), atol=1e-12)
        h = jax.jacfwd(jax.grad(f))(v)
        assert jnp.allclose(h, jax.jacfwd(jax.grad(g))(v), atol=1e-12)
        t3 = jax.jacfwd(jax.jacfwd(jax.grad(f)))(v)
        assert jnp.allclose(
            t3, jax.jacfwd(jax.jacfwd(jax.grad(g)))(v), atol=1e-11
        )

    @pytest.mark.parametrize("d", [2, 3])
    def test_reverse_over_custom_jvp(self, d):
        v, f, g = self._pair(d, 10 + d)
        assert jnp.allclose(
            jax.jacrev(jax.grad(f))(v), jax.jacrev(jax.grad(g))(v),
            atol=1e-12,
        )

    def test_inv_t_value(self):
        import numpy as np

        from mfem_ad_tpu.ad import inv_t

        rng = np.random.default_rng(7)
        for d in (1, 2, 3):
            F = np.eye(d) + 0.3 * rng.standard_normal((d, d))
            got = np.asarray(inv_t(jnp.asarray(F)))
            np.testing.assert_allclose(got, np.linalg.inv(F).T, atol=1e-12)


def test_closed_form_derivatives_match_ad():
    """Analytic gradient/Hessian overrides of the built-in energies must
    equal the AD derivatives of the same ``energy`` body (the integrator
    swaps them into the assembly hot loop; MFEM_AD_TPU_CLOSED=0 gates)."""
    import jax
    import numpy as np

    from mfem_ad_tpu.ad import (
        DiffusionEnergy,
        LinearElasticityEnergy,
        MassEnergy,
        NeoHookeanEnergy,
    )

    rng = np.random.default_rng(42)
    cases = []
    for d in (2, 3):
        x = jnp.asarray(0.1 * rng.standard_normal(d * d))
        pr = {"lambda": jnp.asarray([1.3]), "mu": jnp.asarray([0.7])}
        cases.append((NeoHookeanEnergy(d, 1.3, 0.7), x, pr))
        cases.append((LinearElasticityEnergy(d, 1.3, 0.7), x, pr))
        g = jnp.asarray(rng.standard_normal(d))
        cases.append((DiffusionEnergy(d), g, {}))
        cases.append((DiffusionEnergy(d, 2.5), g,
                      {"K": jnp.asarray([2.5])}))
        cases.append((DiffusionEnergy(d, np.arange(1.0, d + 1)), g,
                      {"K": jnp.arange(1.0, d + 1)}))
        Km = np.eye(d) + 0.1 * rng.standard_normal((d, d))
        cases.append((DiffusionEnergy(d, Km.ravel()), g,
                      {"K": jnp.asarray(Km.ravel())}))
        cases.append((MassEnergy(d), g, {}))
    for f, x, pr in cases:
        g_ad = jax.grad(lambda y: f.energy(y, pr))(x)
        h_ad = jax.jacfwd(jax.grad(lambda y: f.energy(y, pr)))(x)
        g_cl = f.gradient_closed(x, pr)
        h_cl = f.hessian_closed(x, pr)
        name = type(f).__name__
        assert np.allclose(np.asarray(g_ad), np.asarray(g_cl),
                           atol=1e-12), name
        assert np.allclose(np.asarray(h_ad), np.asarray(h_cl),
                           atol=1e-12), name
        assert np.allclose(np.asarray(h_cl), np.asarray(h_cl).T,
                           atol=1e-13), name  # symmetric


def test_closed_form_assembly_matches_ad_route(monkeypatch):
    """Full assembly products (residual / element matrices / diagonal)
    through the closed-form route == the pure-AD route."""
    import numpy as np

    from mfem_ad_tpu import mesh as M
    from mfem_ad_tpu.ad import NeoHookeanEnergy
    from mfem_ad_tpu.adeval import ADEval
    from mfem_ad_tpu.fespace import FESpace
    from mfem_ad_tpu.integrator import ADBlockIntegrator

    m = M.make_cartesian_3d(2, 2, 2)
    sp = FESpace(m, 1, vdim=3)
    intg = ADBlockIntegrator(
        NeoHookeanEnergy(3, 1.0, 0.8), [sp], [ADEval.GRAD | ADEval.VECTOR]
    )
    rng = np.random.default_rng(5)
    u = jnp.asarray(0.02 * rng.standard_normal(sp.ndof))

    monkeypatch.setenv("MFEM_AD_TPU_CLOSED", "1")
    r1 = [np.asarray(r) for r in intg.residual([u])]
    H1 = intg.hess_state([u])
    A1 = np.asarray(intg.element_matrices(H1, 0, 0))
    monkeypatch.setenv("MFEM_AD_TPU_CLOSED", "0")
    r0 = [np.asarray(r) for r in intg.residual([u])]
    H0 = intg.hess_state([u])
    A0 = np.asarray(intg.element_matrices(H0, 0, 0))
    for a, b in zip(r1, r0):
        assert np.allclose(a, b, atol=1e-11)
    assert np.allclose(A1, A0, atol=1e-10)
