"""Nonlinear/linear forms: global operators with essential-BC handling.

JAX equivalents of MFEM's ``NonlinearForm`` / ``BlockNonlinearForm``
/ ``LinearForm`` as used by the reference examples (ex1.cpp:54-60,
ex4.cpp:136-153).  A form owns integrators and an essential-dof mask and
exposes pure, jit-compiled functions of the (concatenated, true-dof) state
vector:

- ``mult(u, fields)``        residual, zeroed at essential dofs (MFEM
                             NonlinearForm::Mult semantics)
- ``energy(u, fields)``      total energy
- ``grad_state(u, fields)``  per-integrator per-qp Hessians (Newton state)
- ``grad_mult(state, v)``    matrix-free Jacobian action, with eliminated
                             rows/columns and identity on essential dofs
- ``grad_diag(state)``       Jacobian diagonal (Jacobi/block preconditioning)
- ``assemble_dense(state)``  dense global matrix (small problems / tests,
                             the UMFPack/MUMPS substitute)

Block systems use MFEM-style true-dof offsets: ``u = concat(u_block0, ...)``
(ex4.cpp:109-114).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .coefficients import as_coefficient
from .fespace import FESpace
from .geometry import geom_factors
from .integrator import ADBlockIntegrator, sym_state_default
from .quadrature import get_rule


class BlockNonlinearForm:
    def __init__(self, spaces):
        if isinstance(spaces, FESpace):
            spaces = [spaces]
        self.spaces = list(spaces)
        sizes = [s.ndof for s in self.spaces]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.ndof = int(self.offsets[-1])
        self.integrators: list[ADBlockIntegrator] = []
        self.ess_mask = jnp.zeros(self.ndof, dtype=bool)
        self._jit_cache: dict[str, object] = {}

    # ------------------------------------------------------------------
    def add_domain_integrator(self, intg: ADBlockIntegrator):
        if len(intg.spaces) != len(self.spaces):
            raise ValueError("integrator/space count mismatch")
        self.integrators.append(intg)
        self._jit_cache.clear()
        return intg

    def set_essential_bc(self, attr_masks):
        """Per-space boundary-attribute masks (None entries = no BC).

        Mirrors BlockNonlinearForm::SetEssentialBC (ex4.cpp:152-153): all
        vdim components of the marked boundaries are constrained.
        """
        mask = np.zeros(self.ndof, dtype=bool)
        for s, am in enumerate(attr_masks):
            if am is None:
                continue
            m = self.spaces[s].essential_mask(am)
            mask[self.offsets[s] : self.offsets[s + 1]] = m
        self.ess_mask = jnp.asarray(mask)
        self._jit_cache.clear()

    def set_essential_dofs(self, dofs_or_mask, space: int = 0):
        arr = np.asarray(dofs_or_mask)
        mask = np.array(np.asarray(self.ess_mask))
        if arr.dtype == bool and arr.size == self.ndof:
            mask = arr.copy()
        else:
            mask[self.offsets[space] + arr.astype(np.int64)] = True
        self.ess_mask = jnp.asarray(mask)
        self._jit_cache.clear()

    # ------------------------------------------------------------------
    def split(self, u):
        return [
            u[self.offsets[s] : self.offsets[s + 1]]
            for s in range(len(self.spaces))
        ]

    def _concat(self, blocks):
        return jnp.concatenate(blocks)

    def _jit(self, key, fn):
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    # ------------------------------------------------------------------
    # All jitted entry points take ``tables`` (the integrators' tabulated
    # arrays) and ``ess`` as explicit arguments rather than closures:
    # closed-over device arrays are embedded as XLA constants, which blows
    # up compile time and memory.
    def _tables(self):
        return tuple(intg.tables for intg in self.integrators)

    # Raw methods are pure in (tables, ess, ...) and safe to call inside any
    # jit/shard_map trace; the public methods below are their jitted
    # single-call wrappers.
    def energy_raw(self, tables, u, fields):
        return sum(
            intg.energy(self.split(u), fields, t)
            for intg, t in zip(self.integrators, tables)
        )

    def mult_raw(self, tables, ess, u, fields):
        blocks = self.split(u)
        acc = jnp.zeros(self.ndof, dtype=u.dtype)
        for intg, t in zip(self.integrators, tables):
            rs = intg.residual(blocks, fields, t)
            acc = acc + self._concat(rs)
        return jnp.where(ess, 0.0, acc)

    def grad_state_raw(self, tables, u, fields):
        # Newton states pack symmetric-compact by default (SymHess): the
        # state is written once per direction and read by every Krylov
        # matvec, so the triangle layout cuts the matvec's HBM traffic
        # ~1.6-1.8x.  MFEM_AD_TPU_SYM_STATE=0 restores full tensors.
        sym = sym_state_default()
        return [
            intg.hess_state(self.split(u), fields, t, sym=sym)
            for intg, t in zip(self.integrators, tables)
        ]

    def grad_mult_raw(self, tables, ess, state, v):
        v0 = jnp.where(ess, 0.0, v)
        blocks = self.split(v0)
        acc = jnp.zeros(self.ndof, dtype=v.dtype)
        for intg, t, Hq in zip(self.integrators, tables, state):
            ys = intg.hess_mult(Hq, blocks, t)
            acc = acc + self._concat(ys)
        return jnp.where(ess, v, acc)

    def grad_diag_raw(self, tables, ess, state):
        acc = jnp.zeros(self.ndof)
        for intg, t, Hq in zip(self.integrators, tables, state):
            ds = intg.diagonal(Hq, t)
            acc = acc + self._concat(ds)
        return jnp.where(ess, 1.0, acc)

    # -- public jitted wrappers ----------------------------------------
    def energy(self, u, fields=None):
        fn = self._jit("energy", self.energy_raw)
        return fn(self._tables(), u, fields or {})

    def mult(self, u, fields=None):
        """Residual with essential rows zeroed (NonlinearForm::Mult)."""
        fn = self._jit("mult", self.mult_raw)
        return fn(self._tables(), self.ess_mask, u, fields or {})

    def grad_state(self, u, fields=None):
        fn = self._jit("grad_state", self.grad_state_raw)
        return fn(self._tables(), u, fields or {})

    def grad_mult(self, state, v):
        """J v with eliminated rows/cols and identity at essential dofs."""
        fn = self._jit("grad_mult", self.grad_mult_raw)
        return fn(self._tables(), self.ess_mask, state, v)

    def grad_diag(self, state):
        fn = self._jit("grad_diag", self.grad_diag_raw)
        return fn(self._tables(), self.ess_mask, state)

    def assemble_dense(self, state) -> np.ndarray:
        """Dense global Jacobian with BC elimination (direct-solver path)."""
        A = np.zeros((self.ndof, self.ndof))
        nb = len(self.spaces)
        for intg, Hq in zip(self.integrators, state):
            for s in range(nb):
                for t in range(nb):
                    blk = intg.assemble_dense_block(Hq, s, t)
                    A[
                        self.offsets[s] : self.offsets[s + 1],
                        self.offsets[t] : self.offsets[t + 1],
                    ] += blk
        ess = np.asarray(self.ess_mask)
        A[ess, :] = 0.0
        A[:, ess] = 0.0
        A[ess, ess] = 1.0
        return A


class NonlinearForm(BlockNonlinearForm):
    """Single-space convenience wrapper (MFEM NonlinearForm)."""

    def __init__(self, space: FESpace):
        super().__init__([space])

    @property
    def space(self) -> FESpace:
        return self.spaces[0]

    def add_ad_integrator(self, f, mode, ir_order=None):
        return self.add_domain_integrator(
            ADBlockIntegrator(f, [self.space], [mode], ir_order=ir_order)
        )


class LinearForm:
    """Load vector b_d = ∫ f φ_d (DomainLFIntegrator) — ex1.cpp:57-60.

    For vdim>1 spaces, ``coeff`` must produce vdim values per point
    (VectorDomainLFIntegrator, ex3.cpp:66).
    """

    def __init__(self, space: FESpace, coeff, ir_order: int | None = None):
        self.space = space
        if callable(coeff) and not hasattr(coeff, "eval_qp"):
            from .coefficients import FunctionCoefficient

            coeff = FunctionCoefficient(coeff, size=space.vdim)
        self.coeff = as_coefficient(coeff)
        self.ir_order = ir_order

    def assemble(self) -> np.ndarray:
        sp = self.space
        order = self.ir_order
        if order is None:
            order = 2 * sp.order + 2
        ir = get_rule(sp.mesh.geom, order)
        phi = sp.elem.eval(ir.points)  # [nq, nd]
        mesh = sp.mesh

        from .coefficients import ConstantCoefficient, FunctionCoefficient

        # The chunked path hands the coefficient a chunk-local QPContext,
        # which is only correct for coefficients that evaluate pointwise
        # from ctx.xq; element-indexed kinds (QuadratureCoefficient,
        # field-backed adapters) must see the full-mesh context.
        pointwise = isinstance(
            self.coeff, (ConstantCoefficient, FunctionCoefficient)
        )
        if (pointwise and mesh.uniform_jacobian
                and mesh.num_elements > (1 << 16)):
            # Chunked affine fast path for large uniform Cartesian meshes:
            # qp coordinates are origin[e] + (J xi)[q], built per chunk
            # into reused buffers instead of one [ne, nq, dim] array —
            # this box-sized working set avoids the fresh-page-fault cost
            # that dominates multi-million-hex load assembly on
            # bandwidth-limited hosts (measured 12 s -> ~5 s at 1M hexes).
            be = self._assemble_uniform_chunked(ir, phi)
        else:
            gf = geom_factors(mesh, ir)

            from .coefficients import QPContext

            ctx = QPContext(gf.xq, ir=ir, mesh=mesh)
            vals = np.asarray(self.coeff.eval_qp(ctx))  # [ne, nq, k]
            if vals.shape[-1] != sp.vdim:
                raise ValueError(
                    f"load coefficient size {vals.shape[-1]} != "
                    f"vdim {sp.vdim}"
                )
            be = np.einsum(
                "qd,eqv,eq->edv", phi, vals, gf.w, optimize=True
            )
        # int32 throughout (ndof < 2^31): the int64 upcast of a [ne, nd]
        # map costs ~1 s at 1M hexes
        idx = np.asarray(sp.edof)[:, :, None] + (
            np.arange(sp.vdim, dtype=np.int32) * np.int32(sp.ndof_scalar)
        )
        # bincount is the buffered scatter-add; np.add.at is an unbuffered
        # ufunc ~30x slower at 1M+ elements (host-setup scaling, VERDICT r1)
        return np.bincount(
            idx.ravel(), weights=be.ravel(), minlength=sp.ndof
        )

    def _assemble_uniform_chunked(self, ir, phi) -> np.ndarray:
        """[ne, nd, vdim] element load vectors, chunked over elements."""
        from .basis import ref_element
        from .coefficients import QPContext

        sp = self.space
        mesh = sp.mesh
        ne, nq = mesh.num_elements, len(ir.weights)
        dim, nd, vdim = mesh.dim, phi.shape[1], sp.vdim
        geo = ref_element(mesh.geom, 1)
        dN = geo.grad(ir.points)  # [nq, nc, dim]
        c0 = mesh.vertices[mesh.elements[0].astype(np.int64)]  # [nc, dim]
        J = np.einsum("cm,ck->km", dN[0], c0)  # constant affine Jacobian
        det = float(np.linalg.det(J))
        if det <= 0:
            raise ValueError("non-positive element Jacobian")
        off = ir.points @ J.T  # [nq, dim] qp offsets within any element
        phiw = phi * (det * ir.weights)[:, None]  # [nq, nd]
        origins = mesh.vertices[mesh.elements[:, 0].astype(np.int64)]

        CH = 1 << 16
        be = np.empty((ne, nd, vdim))
        xbuf = np.empty((CH, nq, dim))
        for s in range(0, ne, CH):
            e = min(s + CH, ne)
            b = e - s
            xb = xbuf[:b]
            np.add(origins[s:e, None, :], off[None, :, :], out=xb)
            ctx = QPContext(xb, ir=ir, mesh=mesh)
            vals = np.asarray(self.coeff.eval_qp(ctx))  # [b, nq, vdim]
            if vals.shape[-1] != vdim:
                raise ValueError(
                    f"load coefficient size {vals.shape[-1]} != "
                    f"vdim {vdim}"
                )
            np.einsum(
                "qd,bqv->bdv", phiw, vals, optimize=True, out=be[s:e]
            )
        return be
