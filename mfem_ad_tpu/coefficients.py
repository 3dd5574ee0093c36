"""Coefficients: spatial data sources evaluated at quadrature points.

The reference's ``Evaluator`` (src/ad_native.hpp:51-135, ad_native.cpp:5-179)
is a std::variant over {scalar, Vector, Matrix, Coefficient*, GridFunction*,
QuadratureFunction*} dispatched per quadrature point.  Batched, that whole
mechanism collapses to: *evaluate every parameter source once into a dense
``[n_elem, n_qp, size]`` array* before assembly, and hand the energy function
a per-qp slice.  Traced array parameters (e.g. the frozen latent psi_k, the
PG step alpha) stay JAX arrays so updating them does not recompile.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Coefficient",
    "ConstantCoefficient",
    "FunctionCoefficient",
    "GridFunctionCoefficient",
    "ScalarFieldCoefficient",
    "QuadratureCoefficient",
    "GridFunctionValueCoefficient",
    "MappedGridFunctionCoefficient",
    "VectorGradientGridFunction",
    "VectorNormCoefficient",
    "BooleanCoefficient",
    "DifferentiableCoefficient",
    "as_coefficient",
]


class QPContext:
    """Evaluation context: physical qp coordinates + the rule that made them.

    Field-backed coefficients need ``ir`` (to tabulate shapes) as well as
    ``xq``; function coefficients need only ``xq``.
    """

    def __init__(self, xq, ir=None, mesh=None):
        self.xq = xq
        self.ir = ir
        self.mesh = mesh


def qp_context(mesh, ir) -> QPContext:
    """Build a QPContext for post-processing evaluation on (mesh, ir)."""
    from .geometry import geom_factors

    return QPContext(geom_factors(mesh, ir).xq, ir=ir, mesh=mesh)


class Coefficient:
    """Base: something that yields [ne, nq, size] given qp coordinates."""

    size: int = 1

    def eval_qp(self, ctx) -> "np.ndarray":
        """ctx is a QPContext with .xq [ne,nq,dim] (+ .ir for FE fields)."""
        raise NotImplementedError


class ConstantCoefficient(Coefficient):
    def __init__(self, value):
        self.value = np.atleast_1d(np.asarray(value, dtype=np.float64)).ravel()
        self.size = self.value.size

    def eval_qp(self, ctx):
        ne, nq = ctx.xq.shape[:2]
        return np.broadcast_to(self.value, (ne, nq, self.size))


class FunctionCoefficient(Coefficient):
    """fn(x) with x a [dim] point; scalar or vector valued.

    Functions written with component indexing (``x[0]``, ``x[1]``, numpy
    ufuncs) evaluate vectorized over all qps at once (x arrives as
    ``[dim, N]``, so ``x[0]`` is the array of first components); anything
    that fails vectorization falls back to a per-point loop.
    """

    def __init__(self, fn, size: int = 1):
        self.fn = fn
        self.size = size

    def eval_qp(self, ctx):
        xq = np.asarray(ctx.xq)
        ne, nq, dim = xq.shape
        flat = xq.reshape(-1, dim)
        n = flat.shape[0]
        try:
            v = np.asarray(self.fn(flat.T), dtype=np.float64)
            if self.size == 1 and v.shape == (n,):
                vals = v[:, None]
            elif v.shape == (self.size, n):
                vals = v.T
            elif v.shape == (self.size,) or v.shape == ():
                # constant-valued fn: broadcast
                vals = np.broadcast_to(
                    np.atleast_1d(v), (n, self.size)
                )
            else:
                raise ValueError("not vectorized")
            # spot-check one point: reject silently-wrong vectorization
            # (e.g. a reduction over x that collapses the point axis)
            v0 = np.atleast_1d(
                np.asarray(self.fn(flat[0]), dtype=np.float64)
            )
            if not np.allclose(vals[0], v0, rtol=1e-12, atol=1e-12):
                raise ValueError("vectorized result mismatch")
        except Exception:
            vals = np.array(
                [self.fn(x) for x in flat], dtype=np.float64
            ).reshape(n, self.size)
        return vals.reshape(ne, nq, self.size)


class GridFunctionCoefficient(Coefficient):
    """Evaluate an FE field at quadrature points.

    Holds a *reference* to (space, getter); the dof vector is supplied at
    assembly time through ``ctx.fields[name]`` so it can be a traced JAX
    array (this is how psi_k enters the PG functional without recompiles —
    cf. reference pg.hpp:106-111 adding the latent GridFunction to the
    Evaluator).
    """

    def __init__(self, space, name: str):
        self.space = space
        self.name = name
        self.size = space.vdim

    def eval_qp(self, ctx):
        return ctx.eval_field(self.space, self.name)


class ScalarFieldCoefficient(Coefficient):
    """A runtime-supplied (traced) scalar/vector parameter, by name.

    Used for quantities that change every outer iteration without
    retracing — e.g. the PG step size alpha (reference pg.hpp:177-180) or
    augmented-Lagrangian multipliers.  The value is taken from the
    ``fields`` dict passed to assembly and broadcast over [ne, nq].
    """

    def __init__(self, name: str, size: int = 1):
        self.name = name
        self.size = size

    def eval_qp(self, ctx):  # resolved inside jit by the integrator
        raise RuntimeError("ScalarFieldCoefficient is resolved at trace time")


class QuadratureCoefficient(Coefficient):
    """Directly supplied per-qp values [ne, nq, size]."""

    def __init__(self, values):
        self.values = values
        self.size = values.shape[-1] if values.ndim == 3 else 1

    def eval_qp(self, ctx):
        v = self.values
        return v if v.ndim == 3 else v[..., None]


def _field_at_qp(space, u, ctx):
    """Evaluate a concrete FE field at the ctx rule's qps: [ne, nq, vdim]."""
    u = np.asarray(u)
    phi = space.elem.eval(ctx.ir.points)  # [nq, nd]
    idx = np.asarray(space.edof)[:, :, None] + (
        np.arange(space.vdim) * space.ndof_scalar
    )
    return np.einsum("qd,edv->eqv", phi, u[idx])


def _field_grad_at_qp(space, u, ctx):
    """Physical gradient of a concrete FE field: [ne, nq, vdim, dim]."""
    from .geometry import phys_dshape

    u = np.asarray(u)
    G = phys_dshape(space.mesh, ctx.ir, space.order)  # [ne, nq, nd, dim]
    idx = np.asarray(space.edof)[:, :, None] + (
        np.arange(space.vdim) * space.ndof_scalar
    )
    return np.einsum("eqdk,edv->eqvk", G, u[idx])


class GridFunctionValueCoefficient(Coefficient):
    """A concrete (host-side) FE field as a coefficient — the by-value
    GridFunction case of the reference Evaluator (ad_native.hpp:82-103)."""

    def __init__(self, space, u):
        self.space = space
        self.u = np.asarray(u)
        self.size = space.vdim

    def eval_qp(self, ctx):
        return _field_at_qp(self.space, self.u, ctx)


class MappedGridFunctionCoefficient(GridFunctionValueCoefficient):
    """Pointwise map of an FE field (reference tools.hpp:6-19)."""

    def __init__(self, space, u, map_fn):
        super().__init__(space, u)
        self.map_fn = map_fn
        self.size = 1

    def eval_qp(self, ctx):
        vals = _field_at_qp(self.space, self.u, ctx)
        out = np.vectorize(self.map_fn)(vals[..., 0] if vals.shape[-1] == 1
                                        else vals)
        return np.asarray(out, dtype=np.float64).reshape(
            vals.shape[0], vals.shape[1], 1
        )


class VectorGradientGridFunction(Coefficient):
    """Gradient of a (vector) FE field as a flattened matrix coefficient
    [vdim*dim] per qp, row-major (reference tools.hpp:20-33)."""

    def __init__(self, space, u):
        self.space = space
        self.u = np.asarray(u)
        self.size = space.vdim * space.mesh.dim

    def eval_qp(self, ctx):
        g = _field_grad_at_qp(self.space, self.u, ctx)  # [ne,nq,vdim,dim]
        return g.reshape(g.shape[0], g.shape[1], self.size)


class VectorNormCoefficient(Coefficient):
    """Euclidean norm of a vector coefficient (reference tools.hpp:200-212)."""

    def __init__(self, base: Coefficient):
        self.base = as_coefficient(base)
        self.size = 1

    def eval_qp(self, ctx):
        v = np.asarray(self.base.eval_qp(ctx))
        return np.linalg.norm(v, axis=-1, keepdims=True)


class BooleanCoefficient(Coefficient):
    """predicate(value) -> {0,1} field — active-set visualization
    (reference tools.hpp:214-226, used at ex5.cpp:131)."""

    def __init__(self, base: Coefficient, predicate):
        self.base = as_coefficient(base)
        self.predicate = predicate
        self.size = 1

    def eval_qp(self, ctx):
        v = np.asarray(self.base.eval_qp(ctx))
        out = self.predicate(v[..., 0] if v.shape[-1] == 1 else v)
        return np.asarray(out, dtype=np.float64).reshape(
            v.shape[0], v.shape[1], 1
        )


class DifferentiableCoefficient(Coefficient):
    """An ADFunction of stacked input coefficients, with ``gradient()`` and
    ``hessian()`` views — the reference's DifferentiableCoefficient
    (ad_native.hpp:267-323), used to evaluate the mirror map u = dE*(psi)
    on a mesh (ex4.cpp:124-128).

    ``inputs`` is a list of coefficients whose sizes sum to f.n_input.
    """

    def __init__(self, f, inputs, deriv: int = 0):
        self.f = f
        self.inputs = [as_coefficient(c) for c in inputs]
        self.deriv = deriv
        n = sum(c.size for c in self.inputs)
        if n != f.n_input:
            raise ValueError(
                f"input coefficients provide {n} values, energy wants "
                f"{f.n_input}"
            )
        self.size = {0: 1, 1: f.n_input, 2: f.n_input * f.n_input}[deriv]

    def gradient(self) -> "DifferentiableCoefficient":
        return DifferentiableCoefficient(self.f, self.inputs, deriv=1)

    def hessian(self) -> "DifferentiableCoefficient":
        return DifferentiableCoefficient(self.f, self.inputs, deriv=2)

    def eval_qp(self, ctx):
        import jax

        x = np.concatenate(
            [np.asarray(c.eval_qp(ctx)) for c in self.inputs], axis=-1
        )
        ne, nq, n = x.shape
        # static (tabulated) parameters of f, evaluated on the same ctx
        p = {k: np.asarray(c.eval_qp(ctx)).reshape(ne * nq, -1)
             for k, c in self.f.params.items()}
        fn = self.f.energy
        if self.deriv == 1:
            fn = jax.grad(self.f.energy)
        elif self.deriv == 2:
            fn = jax.hessian(self.f.energy)
        out = jax.vmap(fn)(x.reshape(ne * nq, n), p)
        return np.asarray(out).reshape(ne, nq, self.size)


def as_coefficient(obj) -> Coefficient:
    if isinstance(obj, Coefficient):
        return obj
    if callable(obj):
        return FunctionCoefficient(obj)
    return ConstantCoefficient(obj)
