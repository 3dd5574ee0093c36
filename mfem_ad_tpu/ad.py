"""AD point-functions: scalar energies and their derivatives via JAX.

This is the JAX replacement for the reference's entire AD core
(/root/reference/src/ad_native.{hpp,cpp}):

- ``ADReal_t``/``AD2Real_t`` dual and nested-dual types (ad_native.hpp:41-49)
  -> JAX tracing.  One plain Python energy ``f(x, params) -> scalar``
  replaces the three ``AD_IMPL`` type instantiations (ad_native.hpp:332-365).
- ``ADFunction::Gradient`` (n seeded forward passes, ad_native.cpp:188-201)
  -> ``jax.grad`` (one reverse pass).
- ``ADFunction::Hessian`` (n(n+1)/2 nested-dual passes, ad_native.cpp:211-230)
  -> ``jax.jacfwd(jax.grad(f))`` (forward-over-reverse).
- dual ``max``/``min`` with subgradient tie-averaging (ad_native.hpp:695-749)
  -> ``admax``/``admin`` below.

Parameters: the reference's ``Evaluator`` machinery is replaced by a dict of
per-qp arrays; each energy declares named ``Coefficient`` sources in
``self.params`` and receives the evaluated per-qp slice as ``p``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .coefficients import Coefficient, as_coefficient

__all__ = [
    "ADFunction",
    "ADVectorFunction",
    "admax",
    "admin",
    "logdet",
    "logdet_flat",
    "inv_t",
    "MassEnergy",
    "DiffusionEnergy",
    "DiffEnergy",
    "LinearElasticityEnergy",
    "Lagrangian",
    "ALFunctional",
]


def admax(a, b):
    """max with subgradient-consistent tie handling (average at equality).

    Mirrors the dual max overload at reference ad_native.hpp:695-721: at a
    tie the derivative is the average of the two branches' derivatives.
    """
    return jnp.where(a > b, a, jnp.where(a < b, b, 0.5 * (a + b)))


def admin(a, b):
    """min with subgradient tie-averaging (ad_native.hpp:723-749)."""
    return jnp.where(a < b, a, jnp.where(a > b, b, 0.5 * (a + b)))


# ---------------------------------------------------------------------------
# Elementwise log-determinant.
#
# The derivative core works on the d*d SCALAR COMPONENTS of F, not on a
# matrix: the point energy is vmapped over [ne, nq], and a matrix
# formulation drags a minor-dim reshape ([.., d*d] -> [.., d, d]) and
# batched tiny dot_generals into the nested-jvp graph, next to the raw
# nested-jvp division chains of log(det F).  Component-level custom_jvp
# rules keep the whole
# differentiated region pure elementwise arithmetic: the JVP of logdet is
# an inner product with F^{-T}'s components, and the JVP of F^{-T} is the
# product form -F^{-T} dF^T F^{-T}, unrolled over indices at trace time.
# Division appears only in primal evaluations, which lower correctly.
# ---------------------------------------------------------------------------


def _cofactor_exprs(f, d: int):
    """Cofactor components C[i][j] ((-1)^{i+j} minors) of flat scalars f."""
    ix = lambda i, j: i * d + j  # noqa: E731
    if d == 1:
        one = f[0] / f[0]  # traced 1 of the right dtype/shape
        return [one]
    if d == 2:
        return [f[ix(1, 1)], -f[ix(1, 0)], -f[ix(0, 1)], f[ix(0, 0)]]
    if d == 3:
        out = []
        for i in range(3):
            i1, i2 = (i + 1) % 3, (i + 2) % 3
            for j in range(3):
                j1, j2 = (j + 1) % 3, (j + 2) % 3
                out.append(
                    f[ix(i1, j1)] * f[ix(i2, j2)]
                    - f[ix(i1, j2)] * f[ix(i2, j1)]
                )
        return out
    raise NotImplementedError(d)


def _det_expr(f, d: int):
    if d == 1:
        return f[0]
    if d == 2:
        return f[0] * f[3] - f[1] * f[2]
    cof = _cofactor_exprs(f, 3)
    return f[0] * cof[0] + f[1] * cof[1] + f[2] * cof[2]


def _make_component_core(d: int):
    ix = lambda i, j: i * d + j  # noqa: E731

    @jax.custom_jvp
    def invt_c(*f):
        """Components of F^{-T} = cofactor(F)/det(F)."""
        det = _det_expr(f, d)
        r = 1.0 / det
        return tuple(c * r for c in _cofactor_exprs(f, d))

    @invt_c.defjvp
    def _invt_c_jvp(primals, tangents):
        i = invt_c(*primals)  # F^{-T} components
        t = tangents  # dF components
        # d(F^{-T}) = -F^{-T} dF^T F^{-T}, unrolled: I[a,k] T[k,b] I[k',b]
        # where I[a,b] = i[ix(a,b)] and dF^T[k,b] = t[ix(b,k)].
        m = [
            [
                sum(i[ix(a, k)] * t[ix(b, k)] for k in range(d))
                for b in range(d)
            ]
            for a in range(d)
        ]
        out = tuple(
            -sum(m[a][k] * i[ix(k, b)] for k in range(d))
            for a in range(d)
            for b in range(d)
        )
        return i, out

    @jax.custom_jvp
    def logdet_c(*f):
        return jnp.log(_det_expr(f, d))

    @logdet_c.defjvp
    def _logdet_c_jvp(primals, tangents):
        i = invt_c(*primals)
        return (
            logdet_c(*primals),
            sum(ic * tc for ic, tc in zip(i, tangents)),
        )

    return logdet_c, invt_c


_CORES = {d: _make_component_core(d) for d in (1, 2, 3)}


def logdet_flat(v, d: int):
    """log(det F) from the flat row-major [d*d] vector of F's entries.

    This is the form hyperelastic energies should use on their GRAD|VECTOR
    input slice (already flat, ad_intg layout): it avoids a
    reshape-to-matrix inside the vmapped AD graph.
    """
    return _CORES[d][0](*(v[..., k] for k in range(d * d)))


def logdet(F):
    """log(det F) for d<=3 with derivative rules closed under nesting.

    Use this (not ``jnp.log(jnp.linalg.det(F))``) in energies so their
    derivatives stay elementwise arithmetic; see
    :func:`logdet_flat` for the reshape-free variant energies should
    prefer on their flat input slice.
    """
    d = F.shape[-1]
    return _CORES[d][0](*(F[..., i, j] for i in range(d) for j in range(d)))


def inv_t(F):
    """F^{-T} for d<=3; derivatives are elementwise product forms."""
    d = F.shape[-1]
    comps = _CORES[d][1](
        *(F[..., i, j] for i in range(d) for j in range(d))
    )
    return jnp.stack(
        [jnp.stack(comps[i * d : (i + 1) * d], axis=-1) for i in range(d)],
        axis=-2,
    )


class ADFunction:
    """Scalar point-function f: R^n -> R, differentiated by JAX.

    Subclass and implement ``energy(self, x, p)`` (the analogue of an
    ``AD_IMPL`` body), or pass a callable.  ``params`` maps names to
    Coefficient-convertible sources, evaluated per quadrature point at
    assembly time; for standalone use pass a dict of arrays directly.
    """

    def __init__(self, n_input: int, fn=None, params: dict | None = None):
        self.n_input = int(n_input)
        if fn is not None:
            self.energy = fn  # type: ignore[method-assign]
        self.params: dict[str, Coefficient] = {}
        for k, v in (params or {}).items():
            self.add_parameter(k, v)

    def add_parameter(self, name: str, src):
        self.params[name] = as_coefficient(src)

    # -- energy body: override me ---------------------------------------
    def energy(self, x, p):
        raise NotImplementedError

    # -- evaluation & derivatives ----------------------------------------
    def __call__(self, x, p=None):
        return self.energy(jnp.asarray(x), p or {})

    def gradient(self, x, p=None):
        return jax.grad(lambda y: self.energy(y, p or {}))(jnp.asarray(x))

    def hessian(self, x, p=None):
        f = lambda y: self.energy(y, p or {})  # noqa: E731
        return jax.jacfwd(jax.grad(f))(jnp.asarray(x))

    def value_grad_hess(self, x, p=None):
        p = p or {}
        x = jnp.asarray(x)
        f = lambda y: self.energy(y, p)  # noqa: E731
        return f(x), jax.grad(f)(x), jax.jacfwd(jax.grad(f))(x)

    # -- optional analytic derivative overrides ---------------------------
    # A subclass MAY implement ``gradient_closed(x, p) -> [n]`` and/or
    # ``hessian_closed(x, p) -> [n, n]`` (symmetric) as hand-derived
    # closed forms of the SAME energy.  The integrator uses them for the
    # batched assembly hot loop when enabled (the per-qp AD Hessian is
    # compute-bound; the built-in energies' closed forms cut its FLOPs ~5-10x
    # — cf. the reference's nested-dual hot loop ad_intg.hpp:260-334).
    # They are golden-tested against the AD derivatives of ``energy`` and
    # can be disabled globally with MFEM_AD_TPU_CLOSED=0 — user-defined
    # energies never need them (AD is the default path, the library's
    # contract: "never hand-code a bilinear form again").
    gradient_closed = None
    hessian_closed = None
    # ``hessian_closed_entries(x, p) -> list[list[h_ab]]`` is the
    # UN-STACKED form of ``hessian_closed``: the n x n entries as plain
    # expressions over the indexables ``x[k]`` / ``p[name][i]`` with no
    # jnp.stack.  ``hessian_closed`` is built from it, and tests use both
    # as oracles for the AD Hessian.  Entries may be constants or
    # sub-shaped (broadcastable); the consumer broadcasts.
    hessian_closed_entries = None


class ADVectorFunction:
    """Vector point-function F: R^n -> R^m (reference ad_native.hpp:198-265).

    ``gradient`` returns the m-by-n Jacobian (ad_native.cpp:232-250);
    ``hessian`` returns the [m, n, n] stack of component Hessians (the
    reference's DenseTensor H(i,j,k) = d2 F_k / dx_i dx_j, transposed to
    component-major).
    """

    def __init__(self, n_input: int, n_output: int, fn=None, params=None):
        self.n_input = int(n_input)
        self.n_output = int(n_output)
        if fn is not None:
            self.function = fn  # type: ignore[method-assign]
        self.params: dict[str, Coefficient] = {}
        for k, v in (params or {}).items():
            self.params[k] = as_coefficient(v)

    def function(self, x, p):
        raise NotImplementedError

    def __call__(self, x, p=None):
        return self.function(jnp.asarray(x), p or {})

    def gradient(self, x, p=None):
        return jax.jacfwd(lambda y: self.function(y, p or {}))(jnp.asarray(x))

    def hessian(self, x, p=None):
        f = lambda y: self.function(y, p or {})  # noqa: E731
        return jax.jacfwd(jax.jacfwd(f))(jnp.asarray(x))


# ---------------------------------------------------------------------------
# Built-in energy library (reference ad_native.hpp:413-691)
# ---------------------------------------------------------------------------


class MassEnergy(ADFunction):
    """0.5 ||x||^2 (ad_native.hpp:413-420).

    Scalar-unrolled (no dot_general/reshape): the per-qp graph is pure
    elementwise arithmetic, which XLA fuses on the batched path.
    """

    def energy(self, x, p):
        return 0.5 * sum(x[k] * x[k] for k in range(self.n_input))

    def gradient_closed(self, x, p):
        return x

    def hessian_closed(self, x, p):
        return jnp.eye(self.n_input, dtype=x.dtype)


class DiffusionEnergy(ADFunction):
    """0.5 grad^T K grad with scalar/vector/matrix K (ad_native.hpp:421-481).

    K may be omitted (identity), or a Coefficient of size 1, dim, or dim^2.
    """

    def __init__(self, dim: int, K=None):
        super().__init__(dim)
        self.dim = dim
        if K is not None:
            self.add_parameter("K", K)
            ksize = self.params["K"].size
            if ksize not in (1, dim, dim * dim):
                raise ValueError(
                    f"K must have size 1, {dim} or {dim*dim}, got {ksize}"
                )

    def energy(self, g, p):
        # scalar-unrolled; see MassEnergy
        d = self.dim
        K = p.get("K")
        gg = sum(g[k] * g[k] for k in range(d))
        if K is None:
            return 0.5 * gg
        if K.shape[-1] == 1:
            return 0.5 * K[0] * gg
        if K.shape[-1] == d:
            return 0.5 * sum(K[k] * g[k] * g[k] for k in range(d))
        return 0.5 * sum(
            g[i] * K[i * d + j] * g[j] for i in range(d) for j in range(d)
        )

    def gradient_closed(self, g, p):
        d = self.dim
        K = p.get("K")
        if K is None:
            return g
        if K.shape[-1] == 1:
            return K[0] * g
        if K.shape[-1] == d:
            return jnp.stack([K[k] * g[k] for k in range(d)])
        Ks = [
            0.5 * (K[i * d + j] + K[j * d + i])
            for i in range(d) for j in range(d)
        ]
        return jnp.stack(
            [sum(Ks[i * d + j] * g[j] for j in range(d)) for i in range(d)]
        )

    def hessian_closed(self, g, p):
        d = self.dim
        K = p.get("K")
        eye = jnp.eye(d, dtype=g.dtype)
        if K is None:
            return eye
        if K.shape[-1] == 1:
            return K[0] * eye
        if K.shape[-1] == d:
            return jnp.stack(
                [
                    jnp.stack(
                        [K[i] if i == j else jnp.zeros_like(K[0])
                         for j in range(d)]
                    )
                    for i in range(d)
                ]
            )
        Km = K.reshape(d, d)
        return 0.5 * (Km + Km.T)


class DiffEnergy(ADFunction):
    """f(x - target) for a wrapped energy f (ad_native.hpp:483-525)."""

    def __init__(self, base: ADFunction, target=None):
        super().__init__(base.n_input)
        self.base = base
        if target is not None:
            self.add_parameter("target", target)

    def energy(self, x, p):
        return self.base.energy(x - p["target"], p)


class LinearElasticityEnergy(ADFunction):
    """0.5 lambda (div u)^2 + mu ||sym grad u||^2 (ad_native.hpp:527-566).

    Input is the flattened gradient gradu[i*dim + j] = d u_i / d x_j
    (component-major), exactly the reference's VECTOR|GRAD layout.
    """

    def __init__(self, dim: int, lam, mu):
        super().__init__(dim * dim)
        self.dim = dim
        self.add_parameter("lambda", lam)
        self.add_parameter("mu", mu)

    def energy(self, gradu, p):
        # scalar-unrolled; see MassEnergy
        d = self.dim
        div = sum(gradu[i * d + i] for i in range(d))
        symsq = 0.0
        for i in range(d):
            for j in range(d):
                s = 0.5 * (gradu[i * d + j] + gradu[j * d + i])
                symsq = symsq + s * s
        return 0.5 * p["lambda"][0] * div * div + p["mu"][0] * symsq

    def gradient_closed(self, gradu, p):
        d = self.dim
        lam, mu = p["lambda"][0], p["mu"][0]
        div = sum(gradu[i * d + i] for i in range(d))
        return jnp.stack(
            [
                mu * (gradu[i * d + j] + gradu[j * d + i])
                + (lam * div if i == j else 0.0)
                for i in range(d) for j in range(d)
            ]
        )

    def hessian_closed_entries(self, gradu, p):
        # H_{(ij),(kl)} = lam d_ij d_kl + mu (d_ik d_jl + d_il d_jk):
        # state-independent (the energy is quadratic)
        d = self.dim
        lam, mu = p["lambda"][0], p["mu"][0]
        n = d * d
        rows = []
        for a in range(n):
            i, j = divmod(a, d)
            row = []
            for b in range(n):
                k, l_ = divmod(b, d)
                h = (
                    lam * (i == j) * (k == l_)
                    + mu * ((i == k) * (j == l_) + (i == l_) * (j == k))
                )
                row.append(h * jnp.ones_like(lam))
            rows.append(row)
        return rows

    def hessian_closed(self, gradu, p):
        return jnp.stack([
            jnp.stack(r) for r in self.hessian_closed_entries(gradu, p)
        ])


class NeoHookeanEnergy(ADFunction):
    """Compressible neo-Hookean hyperelasticity
    W = mu/2 (tr(F^T F) - d) - mu log(det F) + lambda/2 log^2(det F),
    F = I + grad u.  A genuinely nonlinear vector energy (the Hessian
    depends on the state) — the natural large-deformation upgrade of the
    reference's LinearElasticityEnergy (ad_native.hpp:527-566), same
    flattened VECTOR|GRAD input layout; linearizes to it at grad u -> 0.
    """

    def __init__(self, dim: int, lam, mu):
        super().__init__(dim * dim)
        self.dim = dim
        self.add_parameter("lambda", lam)
        self.add_parameter("mu", mu)

    def energy(self, gradu, p):
        d = self.dim
        lam, mu = p["lambda"][0], p["mu"][0]
        # flat row-major F = I + grad u, built per scalar component with
        # Python-float identity entries: no reshape-to-matrix and no array
        # constants, so the AD graph stays pure elementwise arithmetic
        Fc = tuple(
            gradu[k] + (1.0 if k % (d + 1) == 0 else 0.0)
            for k in range(d * d)
        )
        I1 = sum(c * c for c in Fc)
        logJ = _CORES[d][0](*Fc)
        return 0.5 * mu * (I1 - d) - mu * logJ + 0.5 * lam * logJ * logJ

    def _inv_logj(self, gradu):
        """Flat row-major F, its closed-form inverse, and log det F."""
        d = self.dim
        Fc = [
            gradu[k] + (1.0 if k % (d + 1) == 0 else 0.0)
            for k in range(d * d)
        ]
        if d == 2:
            det = Fc[0] * Fc[3] - Fc[1] * Fc[2]
            r = 1.0 / det
            inv = [Fc[3] * r, -Fc[1] * r, -Fc[2] * r, Fc[0] * r]
        elif d == 3:
            c00 = Fc[4] * Fc[8] - Fc[5] * Fc[7]
            c01 = Fc[5] * Fc[6] - Fc[3] * Fc[8]
            c02 = Fc[3] * Fc[7] - Fc[4] * Fc[6]
            det = Fc[0] * c00 + Fc[1] * c01 + Fc[2] * c02
            r = 1.0 / det
            inv = [
                c00 * r,
                (Fc[2] * Fc[7] - Fc[1] * Fc[8]) * r,
                (Fc[1] * Fc[5] - Fc[2] * Fc[4]) * r,
                c01 * r,
                (Fc[0] * Fc[8] - Fc[2] * Fc[6]) * r,
                (Fc[2] * Fc[3] - Fc[0] * Fc[5]) * r,
                c02 * r,
                (Fc[1] * Fc[6] - Fc[0] * Fc[7]) * r,
                (Fc[0] * Fc[4] - Fc[1] * Fc[3]) * r,
            ]
        else:  # d == 1
            det = Fc[0]
            inv = [1.0 / Fc[0]]
        return Fc, inv, jnp.log(det)

    def gradient_closed(self, gradu, p):
        # dW/dF = mu F + (lam logJ - mu) F^{-T}
        d = self.dim
        lam, mu = p["lambda"][0], p["mu"][0]
        Fc, inv, logJ = self._inv_logj(gradu)
        c = lam * logJ - mu
        return jnp.stack(
            [
                mu * Fc[i * d + j] + c * inv[j * d + i]
                for i in range(d) for j in range(d)
            ]
        )

    def hessian_closed_entries(self, gradu, p):
        # H_{(ij),(kl)} = mu d_ik d_jl + lam Ft_ij Ft_kl
        #                 + (mu - lam logJ) Finv_jk Finv_li,
        # Ft = F^{-T}: the standard compressible neo-Hookean tangent
        # (dF^{-1}_ab/dF_kl = -F^{-1}_ak F^{-1}_lb, dlogJ/dF = F^{-T}).
        d = self.dim
        lam, mu = p["lambda"][0], p["mu"][0]
        _, inv, logJ = self._inv_logj(gradu)
        c2 = mu - lam * logJ
        n = d * d
        rows = []
        for a in range(n):
            i, j = divmod(a, d)
            row = []
            for b in range(n):
                k, l_ = divmod(b, d)
                h = (
                    lam * inv[j * d + i] * inv[l_ * d + k]
                    + c2 * inv[j * d + k] * inv[l_ * d + i]
                )
                if a == b:
                    h = h + mu
                row.append(h)
            rows.append(row)
        return rows

    def hessian_closed(self, gradu, p):
        return jnp.stack([
            jnp.stack(r) for r in self.hessian_closed_entries(gradu, p)
        ])


class Lagrangian(ADFunction):
    """f(x) + sum_i lambda_i c_i(x) (ad_native.hpp:570-621).

    Input is [x (n_obj), lambda (n_con)].  Eval-mode switching mirrors
    FullMode/ObjectiveMode/EqConstraintMode; the mode is a Python-level
    (static) switch, so changing it retraces — modes are set once per solve
    in practice.
    """

    FULL, OBJONLY = -1, -2

    def __init__(self, objective: ADFunction, n_eq_con: int):
        super().__init__(objective.n_input + n_eq_con)
        self.objective = objective
        self.eq_con: list[ADFunction] = []
        self.eval_mode = self.FULL

    def add_eq_constraint(self, c: ADFunction):
        self.eq_con.append(c)
        return self

    def full_mode(self):
        self.eval_mode = self.FULL

    def objective_mode(self):
        self.eval_mode = self.OBJONLY

    def eq_constraint_mode(self, i: int):
        assert 0 <= i < len(self.eq_con)
        self.eval_mode = i

    def energy(self, x_and_lambda, p):
        n = self.objective.n_input
        x = x_and_lambda[:n]
        lam = x_and_lambda[n:]
        if self.eval_mode >= 0:
            return self.eq_con[self.eval_mode].energy(x, p)
        result = self.objective.energy(x, p)
        if self.eval_mode == self.OBJONLY:
            return result
        for i, c in enumerate(self.eq_con):
            result = result + c.energy(x, p) * lam[i]
        return result


class ALFunctional(ADFunction):
    """Augmented Lagrangian f + sum [lam_i c_i + (mu/2) c_i^2]
    (ad_native.hpp:624-691), with c_i(x) = constraint_i(x) - rhs_i.

    ``lam`` and ``penalty`` are JAX-traceable attributes updated between
    solves (SetLambda/SetPenalty equivalents) — pass them via set_multipliers
    so updating them does not retrace.
    """

    FULLAL, OBJONLY = -1, -2

    def __init__(self, objective: ADFunction):
        super().__init__(objective.n_input)
        self.objective = objective
        self.eq_con: list[ADFunction] = []
        self.eq_rhs: list[float] = []
        self.lam = jnp.zeros(0)
        self.penalty = 1.0
        self.eval_mode = self.FULLAL

    def add_eq_constraint(self, c: ADFunction, target: float = 0.0):
        self.eq_con.append(c)
        self.eq_rhs.append(target)
        self.lam = jnp.zeros(len(self.eq_con))
        return self

    def set_multipliers(self, lam):
        self.lam = jnp.asarray(lam)

    def set_penalty(self, mu: float):
        self.penalty = mu

    def al_mode(self):
        self.eval_mode = self.FULLAL

    def objective_mode(self):
        self.eval_mode = self.OBJONLY

    def eq_constraint_mode(self, i: int):
        assert 0 <= i < len(self.eq_con)
        self.eval_mode = i

    def energy(self, x, p):
        if self.eval_mode >= 0:
            i = self.eval_mode
            return self.eq_con[i].energy(x, p) - self.eq_rhs[i]
        result = self.objective.energy(x, p)
        if self.eval_mode == self.OBJONLY:
            return result
        for i, c in enumerate(self.eq_con):
            cx = c.energy(x, p) - self.eq_rhs[i]
            result = result + cx * (self.lam[i] + 0.5 * self.penalty * cx)
        return result


class EmptyEnergy(ADFunction):
    """Zero energy placeholder (reference _dof_pg.hpp:9-15)."""

    def energy(self, x, p):
        return jnp.zeros(())
