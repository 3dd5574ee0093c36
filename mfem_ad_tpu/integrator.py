"""Batched AD assembly: energy, residual, Jacobian from a point energy.

Batched-tensor redesign of the reference's AD integrators
(/root/reference/src/_ad_intg.hpp, src/ad_intg.hpp).  The reference's
per-element virtual dispatch + per-qp dual-number loops become three batched
tensor programs over ``[n_elem, n_qp]``:

- energy      = sum_eq f(B^T u) * w                 (GetElementEnergy,
                ad_intg.hpp:157-199)
- residual    = scatter(B (grad f) w)               (AssembleElementVector,
                ad_intg.hpp:202-257)
- Jacobian    = B H B^T w, applied matrix-free or as element blocks
                (AssembleElementGrad, ad_intg.hpp:260-334)

A single ``ADBlockIntegrator`` covers both the single-space integrator
(``ADNonlinearFormIntegrator<mode>``) and the multi-space block integrator
(``ADBlockNonlinearFormIntegrator<modes...>``, ad_intg.hpp:363-729): one
space is just a one-block system.  The per-qp stacked input layout matches
the reference exactly (see adeval.py).

The per-qp Hessian tensor ``Hq = w * d2f/dx2 [ne, nq, n, n]`` is the
"assembled state" of a Newton iterate: computing it once and applying
``v -> scatter(B (Hq (B^T v)))`` is partial assembly — the accelerator-idiomatic
replacement for assembling a global sparse matrix.

All compute methods take the array bundle ``tables`` explicitly (defaulting
to ``self.tables``) so ``parallel.ShardedForm`` can shard the element axis
across a device mesh with ``shard_map`` and reduce with ``psum``.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from .ad import ADFunction, ADVectorFunction
from .adeval import ADEval, build_B, shapedim
from .coefficients import (
    Coefficient,
    GridFunctionCoefficient,
    QPContext,
    ScalarFieldCoefficient,
)
from .fespace import FESpace
from .geometry import geom_factors
from .quadrature import default_ad_order, get_rule


def qpmap(fn):
    """vmap a per-qp function over [ne, nq] leading dims (pytree-aware)."""
    return jax.vmap(jax.vmap(fn))


# ---------------------------------------------------------------------------
# Compact symmetric Hessian state
#
# The per-qp energy Hessian Hq is symmetric (Schwarz), so the Newton state
# read by EVERY Krylov matvec of a solve carries n(n-1)/2 redundant entries:
# 16 -> 10 at n=4 (ex4/ex5 LVPP), 81 -> 45 at n=9 (3D elasticity).  The
# matvec is memory-bound, so storing the upper triangle [ne, nq, K],
# K = n(n+1)/2, cuts the dominant traffic term ~1.6-1.8x.
# Matches the storage discipline of the reference's hot loop, which fills
# only the symmetric half per qp (ad_native.cpp:211-230, ad_intg.hpp:
# 260-334).
#
# The ASSEMBLY route keeps the full tensor: a triangle relayout inside the
# one-shot A = H @ W pass is a minor-dim relayout of the whole intermediate
# (see the W0/Wsym note below).  Here the relayout is paid ONCE per Newton
# direction (hess_state) and repaid every Krylov iteration.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _tri_maps(n: int):
    """Static maps for the packed upper triangle of a symmetric n x n.

    Returns (SU, SL, SUo, expand):
      SU  [n, K]  SU[a_k, k] = 1      (row selector of pair k = (a_k, b_k))
      SL  [n, K]  SL[b_k, k] = 1      (col selector)
      SUo [n, K]  SU with diagonal pairs (a_k == b_k) zeroed
      expand [n*n] int32: flat (i, j) -> packed index of (min, max)
    """
    pairs = [(a, b) for a in range(n) for b in range(a, n)]
    K = len(pairs)
    SU = np.zeros((n, K))
    SL = np.zeros((n, K))
    SUo = np.zeros((n, K))
    ki = {}
    for k, (a, b) in enumerate(pairs):
        SU[a, k] = 1.0
        SL[b, k] = 1.0
        if a != b:
            SUo[a, k] = 1.0
        ki[(a, b)] = k
    expand = np.empty(n * n, np.int32)
    for i in range(n):
        for j in range(n):
            expand[i * n + j] = ki[(min(i, j), max(i, j))]
    return SU, SL, SUo, expand


@jax.tree_util.register_pytree_node_class
class SymHess:
    """Packed symmetric per-qp Hessian state: triangle PLANES [K, ne, nq]
    (K = n(n+1)/2, pair order (a, b), a <= b).

    The plane-major layout is the one XLA naturally materializes for the
    jacfwd Hessian (the jitted state comes back (n, m) major, batch
    minor), so both the state write and every matvec read are
    layout-native.  A batch-major ``[ne, nq, K]`` triangle applied with
    selector matmuls instead relays out the whole state on every Krylov
    iteration; the plane-major unrolled-FMA apply below never does.

    Produced by ``hess_state(..., sym=True)`` (the Newton-state path,
    forms.grad_state_raw); consumed natively by ``hess_mult`` (full-width
    elementwise FMA chains) and expanded once per Newton direction by
    ``diagonal``/``element_matrices``.  Registered as a pytree so it
    crosses jit/shard_map boundaries; the ELEMENT axis is dim 1 of the
    planes — sharded forms spec it as P(None, axis).
    """

    def __init__(self, planes, n: int):
        self.planes = planes
        self.n = int(n)

    def tree_flatten(self):
        return (self.planes,), self.n

    @classmethod
    def tree_unflatten(cls, n, children):
        return cls(children[0], n)

    @property
    def shape(self):
        ne, nq = self.planes.shape[1], self.planes.shape[2]
        return (ne, nq, self.n, self.n)

    @property
    def dtype(self):
        return self.planes.dtype

    def full(self):
        """Expand to the full [ne, nq, n, n] tensor (leading-dim gather of
        the planes; once-per-direction consumers only — never in the
        matvec)."""
        n = self.n
        expand = _tri_maps(n)[3]
        out = self.planes[expand]  # [n*n, ne, nq]
        out = out.reshape((n, n) + self.planes.shape[1:])
        return jnp.moveaxis(out, (0, 1), (2, 3))


def sym_state_default() -> bool:
    """Policy: pack the Newton state symmetric-compact (default on).

    Env override MFEM_AD_TPU_SYM_STATE=0; read at trace time, so flips
    after a form's jit cache is warm do not retroactively apply.
    """
    return os.environ.get("MFEM_AD_TPU_SYM_STATE", "1") != "0"


def _closed_enabled() -> bool:
    """Policy: use analytic gradient/Hessian overrides of built-in
    energies when defined.  DEFAULT OFF: the closed neo-Hookean Hessian
    cuts the per-qp FLOPs ~5-10x, but its hand-built H stack forces a
    relayout of the whole Hq intermediate that the jacfwd producer,
    whose layout XLA assigns together with the A = H @ W GEMM, avoids.
    No GPU measurement decides between them yet.  MFEM_AD_TPU_CLOSED=1
    opts in."""
    return os.environ.get("MFEM_AD_TPU_CLOSED", "0") == "1"


def _dedup_elements(arr: np.ndarray) -> np.ndarray:
    """Collapse the element axis to 1 when every element is identical.

    On uniform Cartesian meshes (all of the reference's benchmark meshes,
    ex1.cpp:35, ex4.cpp:78) the physical shape tables and static coefficient
    values are element-invariant; storing them [1, nq, ...] shrinks HBM
    residency and host->device transfer by a factor of n_elem and lets XLA
    keep the shared table in fast on-chip memory across the element batch.
    """
    if arr.shape[0] > 1:
        scale = np.abs(arr).max() or 1.0
        if np.allclose(arr, arr[:1], rtol=0.0, atol=1e-12 * scale):
            return arr[:1]
    return arr


def _ne_nq(t) -> tuple:
    """(n_elem, n_qp) of a tables bundle; w may be element-shared [1, nq]."""
    ne = t["edof"][0].shape[0]
    return ne, t["w"].shape[1]


def _space_gridmeta(space):
    """Static metadata for the gather-free dof exchange of a space.

    Returns ("l2",) for element-contiguous L2 dofs (reshape),
    ("h1", dims, ndims, node_offsets, p) for lexicographically-numbered
    structured H1 dofs (strided slices / dilated pads),
    ("h1t", dims, ndims, offsets[2, nd, 2], p) for structured TRIANGLE
    meshes (two slice groups, one per orientation, interleaved into the
    e = 2*cell + t element order), or None (generic edof gather/scatter).
    """
    g = getattr(space, "grid", None)
    if g is None:
        return None
    if g[0] == "l2":
        return ("l2",)
    p = space.order
    if g[0] == "h1t":
        rs = np.asarray(space.elem.nodes)  # [nd, 2] reference (r, s)
        r, s = rs[:, 0], rs[:, 1]
        # cell split along the SW-NE diagonal (mesh.make_cartesian_2d):
        #   t=0 (v00, v10, v11): X = (r + s, s) in cell units
        #   t=1 (v00, v11, v01): X = (r, r + s)
        offs = np.stack([
            np.stack([np.rint(p * (r + s)), np.rint(p * s)], axis=1),
            np.stack([np.rint(p * r), np.rint(p * (r + s))], axis=1),
        ]).astype(np.int64)  # [2, nd, (ai, aj)]
        return ("h1t", g[1], g[2], offs, p)
    offs = np.rint(np.asarray(space.elem.nodes) * p).astype(np.int64)
    return ("h1", g[1], g[2], offs, p)


def _meta_ne(meta, nds: int, nd: int) -> int:
    """True (unpadded) element count implied by a grid meta."""
    if meta[0] == "l2":
        return nds // nd
    ne = int(np.prod(meta[1]))
    return 2 * ne if meta[0] == "h1t" else ne


def _halo_local_meta(meta, K: int):
    """Shard-local grid meta for a K-way band partition along the
    element-major grid axis (dof-grid dim 0: Y in 2D, X in 3D — the axis
    the element ordering is outer-major in, fespace.py lattice builders).

    Shard k owns the cell band [k*n_loc, (k+1)*n_loc) of the outer axis;
    its local dof block spans n_loc*p + 1 planes (the last plane is the
    shared interface, owned by shard k+1 — the "ghost" plane of the
    owner-zero distributed layout; the final shard owns its last plane).
    """
    kind, dims, ndims, offs, p = meta
    if len(dims) == 2:
        nx, ny = dims  # 2D element order e = j*nx + i: outer = ny
        if ny % K:
            raise ValueError(f"halo partition needs ny % K == 0 ({ny}, {K})")
        nl = ny // K
        ldims = (nx, nl)
    else:
        nx, ny, nz = dims  # 3D order e = i*ny*nz + ...: outer = nx
        if nx % K:
            raise ValueError(f"halo partition needs nx % K == 0 ({nx}, {K})")
        nl = nx // K
        ldims = (nl, ny, nz)
    lndims = (nl * p + 1,) + tuple(ndims[1:])
    return (kind, ldims, lndims, offs, p)


def _halo_perm_fwd(K: int):
    """ppermute pairs sending shard k's plane to shard k+1 (scatter
    return of interface contributions to their owner)."""
    return [(k, k + 1) for k in range(K - 1)]


def _halo_perm_bwd(K: int):
    """ppermute pairs sending shard k+1's first plane back to shard k
    (ghost fill before a local gather)."""
    return [(k + 1, k) for k in range(K - 1)]


def _fast_gather(u, meta, vdim: int, nd: int):
    """Gather element dofs [ne, nd, vdim] without a gather op (or None).

    L2 reshapes and structured-H1 strided slices replace the generic
    index gather entirely (contiguous reads, no index arrays).
    """
    if meta is None:
        return None
    if meta[0] == "l2":
        return u.reshape(vdim, -1, nd).transpose(1, 2, 0)
    _, dims, ndims, offs, p = meta
    ne = int(np.prod(dims))
    U = u.reshape((vdim,) + tuple(ndims))
    cols = []
    if meta[0] == "h1t":
        # structured triangles: one slice set per orientation, interleaved
        # back into the mesh's e = 2*cell + t element order
        nx, ny = dims
        per_t = []
        for t in range(2):
            tcols = []
            for d in range(nd):
                ai, aj = int(offs[t, d, 0]), int(offs[t, d, 1])
                sl = jax.lax.slice(
                    U,
                    (0, aj, ai),
                    (vdim, aj + (ny - 1) * p + 1, ai + (nx - 1) * p + 1),
                    (1, p, p),
                )
                tcols.append(sl.reshape(vdim, ne))
            per_t.append(jnp.stack(tcols, axis=0))  # [nd, vdim, ne_cell]
        both = jnp.stack(per_t, axis=0)  # [t, nd, vdim, cell]
        return both.transpose(3, 0, 1, 2).reshape(2 * ne, nd, vdim)
    if len(dims) == 2:
        nx, ny = dims
        for d in range(nd):
            ai, aj = int(offs[d, 0]), int(offs[d, 1])
            sl = jax.lax.slice(
                U,
                (0, aj, ai),
                (vdim, aj + (ny - 1) * p + 1, ai + (nx - 1) * p + 1),
                (1, p, p),
            )
            cols.append(sl.reshape(vdim, ne))
    else:
        nx, ny, nz = dims
        for d in range(nd):
            ai, aj, ak = (int(offs[d, k]) for k in range(3))
            sl = jax.lax.slice(
                U,
                (0, ai, aj, ak),
                (
                    vdim,
                    ai + (nx - 1) * p + 1,
                    aj + (ny - 1) * p + 1,
                    ak + (nz - 1) * p + 1,
                ),
                (1, p, p, p),
            )
            cols.append(sl.reshape(vdim, ne))
    return jnp.stack(cols, axis=0).transpose(2, 0, 1)


def _fast_scatter(re, meta, vdim: int, nd: int):
    """Scatter-add element values into the dof vector without a scatter op.

    The structured-H1 path sums interior-dilated ``lax.pad``s — the exact
    adjoint of the strided-slice gather.  Returns None when no fast path.
    """
    if meta is None:
        return None
    if meta[0] == "l2":
        return re.transpose(2, 0, 1).reshape(-1)
    _, dims, ndims, offs, p = meta
    zero = jnp.zeros((), dtype=re.dtype)
    out = jnp.zeros((vdim,) + tuple(ndims), dtype=re.dtype)
    if meta[0] == "h1t":
        nx, ny = dims
        ne = nx * ny
        re4 = re.reshape(ne, 2, nd, vdim)  # e = 2*cell + t
        for t in range(2):
            for d in range(nd):
                ai, aj = int(offs[t, d, 0]), int(offs[t, d, 1])
                v2 = re4[:, t, d, :].T.reshape(vdim, ny, nx)
                out = out + jax.lax.pad(
                    v2,
                    zero,
                    (
                        (0, 0, 0),
                        (aj, ndims[0] - 1 - (aj + (ny - 1) * p), p - 1),
                        (ai, ndims[1] - 1 - (ai + (nx - 1) * p), p - 1),
                    ),
                )
        return out.reshape(-1)
    if len(dims) == 2:
        nx, ny = dims
        for d in range(nd):
            ai, aj = int(offs[d, 0]), int(offs[d, 1])
            v2 = re[:, d, :].T.reshape(vdim, ny, nx)
            out = out + jax.lax.pad(
                v2,
                zero,
                (
                    (0, 0, 0),
                    (aj, ndims[0] - 1 - (aj + (ny - 1) * p), p - 1),
                    (ai, ndims[1] - 1 - (ai + (nx - 1) * p), p - 1),
                ),
            )
    else:
        nx, ny, nz = dims
        for d in range(nd):
            ai, aj, ak = (int(offs[d, k]) for k in range(3))
            v3 = re[:, d, :].T.reshape(vdim, nx, ny, nz)
            out = out + jax.lax.pad(
                v3,
                zero,
                (
                    (0, 0, 0),
                    (ai, ndims[0] - 1 - (ai + (nx - 1) * p), p - 1),
                    (aj, ndims[1] - 1 - (aj + (ny - 1) * p), p - 1),
                    (ak, ndims[2] - 1 - (ak + (nz - 1) * p), p - 1),
                ),
            )
    return out.reshape(-1)


def _edof_inverse(edof: np.ndarray, nds: int) -> np.ndarray:
    """Transpose of the element-dof map: [nds, V] indices into the
    flattened [ne*nd] element-value array (V = max dof valence), padded
    with the sentinel ne*nd (a zero slot appended by the consumer).

    Converts the generic unstructured scatter-add — a scatter op whose
    colliding indices serialize — into gather + sum over a static
    valence axis (every output dof reads its incident element slots),
    which XLA lowers as a plain gather + reduction.
    """
    ne, nd = edof.shape
    lists: list = [[] for _ in range(nds)]
    flat = edof.reshape(-1)
    for slot, dof in enumerate(flat):
        lists[int(dof)].append(slot)
    V = max(len(x) for x in lists) if lists else 1
    inv = np.full((nds, V), ne * nd, dtype=np.int32)
    for j, x in enumerate(lists):
        inv[j, : len(x)] = x
    return inv


def _x_from_u(B, ue):
    """x = B^T u per qp: [ne, nq, vdim, sd]; B may be element-shared."""
    if B.shape[0] == 1:
        return jnp.einsum("qds,edv->eqvs", B[0], ue)
    return jnp.einsum("eqds,edv->eqvs", B, ue)


def _r_from_g(B, g):
    """r_e = B g per element: [ne, nd, vdim] from g [ne, nq, vdim, sd]."""
    if B.shape[0] == 1:
        return jnp.einsum("qds,eqvs->edv", B[0], g)
    return jnp.einsum("eqds,eqvs->edv", B, g)


def _diag_from_h(B, Hvv):
    """Element-diagonal d_e[d,v] = sum_q B[d,:] Hvv[:,:,v] B[d,:]."""
    if B.shape[0] == 1:
        return jnp.einsum("qds,eqstv,qdt->edv", B[0], Hvv, B[0])
    return jnp.einsum("eqds,eqstv,eqdt->edv", B, Hvv, B)


def _elmat_from_h(Bs, Bt, H6):
    """Dense element blocks A_e[(v,d),(w,k)] = B_s H B_t^T summed over qp."""
    ss = "qds" if Bs.shape[0] == 1 else "eqds"
    st = "qkt" if Bt.shape[0] == 1 else "eqkt"
    a = Bs[0] if Bs.shape[0] == 1 else Bs
    b = Bt[0] if Bt.shape[0] == 1 else Bt
    return jnp.einsum(f"{ss},eqvswt,{st}->evdwk", a, H6, b)




class _PullbackEnergy(ADFunction):
    """Affine-geometry pullback wrapper (round 4, VERDICT r3 #5).

    Evaluates the user energy on PHYSICAL per-qp inputs reconstructed
    from REFERENCE-basis inputs via the per-element inverse Jacobian
    (``p["_invj"]``): physical gradients are ``invj^T @ ref-gradients``.
    On an affine unstructured mesh (every simplex mesh; constant J per
    element) this keeps the shape tensor ELEMENT-SHARED, so all the
    shared-B GEMM machinery (R0/W0/W0p/D0 factors) applies verbatim —
    and the chain-rule congruence ``H_ref = P^T H_phys P`` happens
    inside the traced AD graph for free.  The same separation of
    reference basis from geometry underlies MFEM's partial assembly
    (the reference's CalcPhysDShape bakes the geometry into B instead,
    ad_intg.hpp:119-154, which forces element-varying shape tensors).
    """

    def __init__(self, f, layout, dim: int):
        super().__init__(f.n_input)
        self.f = f
        self.layout = layout  # per space: (offset, vdim, sd, cols)
        self.dim = dim
        self.params = f.params  # coefficient evaluation unchanged

    def energy(self, x, p):
        J = p["_invj"]  # [dim*dim] per point, row-major J^{-1}[m, k]
        d = self.dim
        out = []
        for off, v, sd, cols in self.layout:
            for c in range(v):
                base = off + c * sd
                k = 0
                for kind in cols:
                    if kind == "v":
                        out.append(x[base + k])
                        k += 1
                    else:  # reference-gradient block -> physical
                        for kk in range(d):
                            acc = J[kk] * x[base + k]
                            for mm in range(1, d):
                                acc = acc + (
                                    J[mm * d + kk] * x[base + k + mm]
                                )
                            out.append(acc)
                        k += d
        return self.f.energy(jnp.stack(out), p)


class ADBlockIntegrator:
    """Domain integrator of a scalar energy over one or more FE spaces.

    Args:
        f: the ADFunction energy (its ``params`` coefficients are evaluated
           here; GridFunction/ScalarField-backed ones become runtime fields).
        spaces: list of FESpace, one per block.
        modes: list of ADEval, one per space.
        ir_order: quadrature order (default 2*max(p)+2, _ad_intg.hpp:104).
        dtype: computation dtype for the tabulated tensors.

    Array state lives in ``self.tables`` (a pytree):
        B:      tuple of [ne, nq, nd_s, sd_s]
        w:      [ne, nq]
        edof:   tuple of [ne, nd_s] int32
        static: dict name -> [ne, nq, k]      (static coefficient values)
        field:  dict name -> field-eval arrays (gf: (edof, phi))
    """

    def __init__(
        self,
        f: ADFunction,
        spaces,
        modes,
        ir_order: int | None = None,
        dtype=None,
    ):
        if isinstance(spaces, FESpace):
            spaces = [spaces]
        if isinstance(modes, ADEval):
            modes = [modes]
        assert len(spaces) == len(modes)
        self.f = f
        self.spaces = list(spaces)
        self.modes = list(modes)
        mesh = spaces[0].mesh
        for s in spaces:
            if s.mesh is not mesh:
                raise ValueError("all spaces must share one mesh")
        self.mesh = mesh
        if ir_order is None:
            ir_order = default_ad_order(max(s.order for s in spaces))
        self.ir = get_rule(mesh.geom, ir_order)
        gf = geom_factors(mesh, self.ir)
        self.xq_np = gf.xq
        dtype = dtype or jnp.zeros(0).dtype  # respects jax_enable_x64
        self.dtype = dtype

        self.nq = self.ir.npoints
        sdim = mesh.dim
        self.sd = [shapedim(m, sdim) for m in modes]
        self.vdim = [s.vdim for s in spaces]
        self.nd = [s.nd for s in spaces]
        self.nds = [s.ndof_scalar for s in spaces]
        self.widths = [sd * v for sd, v in zip(self.sd, self.vdim)]
        self.x_off = np.concatenate([[0], np.cumsum(self.widths)])
        self.n_input = int(self.x_off[-1])
        if self.n_input != f.n_input:
            raise ValueError(
                f"energy n_input={f.n_input} but input layout has width "
                f"{self.n_input} (widths per space: {self.widths})"
            )
        # Vector point-functions as integrands (reference aliasing
        # Gradient -> evaluate, Hessian -> Jacobian, ad_native.hpp:233-248):
        # the per-qp "gradient" is F(x) itself (a pointwise flux defining
        # the weak residual r = scatter(B F(B^T u) w)) and the Newton state
        # is the Jacobian dF/dx — generally NONsymmetric, so the
        # symmetric-only routes (SymHess packing, the vdim-block mirror)
        # are disabled for these integrands.
        self.vector_fn = isinstance(f, ADVectorFunction)
        if self.vector_fn and f.n_output != self.n_input:
            raise ValueError(
                f"vector integrand n_output={f.n_output} must equal the "
                f"input layout width {self.n_input} (ad_native.hpp:233-248)"
            )
        for s, m in zip(spaces, modes):
            if s.vdim > 1 and not (m & ADEval.VECTOR):
                raise ValueError("vdim > 1 requires ADEval.VECTOR")
        self._gridmeta = [_space_gridmeta(s) for s in spaces]

        # ---- geometry pullback (unstructured meshes): build the shape
        # tensor from the REFERENCE basis (element-shared, so the fast
        # GEMM factors apply) and absorb the geometry into the traced
        # energy via _PullbackEnergy.  Round 4 gated this to affine
        # meshes (constant J per element — every simplex mesh); round 5
        # extends it to element-varying J (perturbed/curved quads and
        # hexes): the per-qp ``_invj`` table simply carries the full
        # [ne, nq] inverse Jacobians — the shared-B GEMM structure is a
        # property of the reference basis, not of the geometry
        # (VERDICT r4 #8; the reference's CalcPhysDShape instead bakes
        # geometry into B, forcing element-varying shape tensors,
        # ad_intg.hpp:119-154).
        self.pullback = False
        gf_b = gf
        if not mesh.uniform_jacobian and not self.vector_fn:
            ok_modes = all(
                not (m & (ADEval.DIV | ADEval.CURL | ADEval.QVALUE))
                for m in modes
            )
            if (
                ok_modes
                and os.environ.get("MFEM_AD_TPU_PULLBACK") != "0"
            ):
                self.pullback = True
                from .geometry import GeomFactors

                eyeJ = np.broadcast_to(np.eye(sdim), gf.invj.shape)
                gf_b = GeomFactors(
                    xq=gf.xq, jac=eyeJ, detj=gf.detj, invj=eyeJ, w=gf.w
                )
                layout = []
                for si in range(len(spaces)):
                    cols = []
                    if modes[si] & ADEval.VALUE:
                        cols.append("v")
                    if modes[si] & ADEval.GRAD:
                        cols.append("g")
                    layout.append((
                        int(self.x_off[si]), self.vdim[si], self.sd[si],
                        tuple(cols),
                    ))
                self.f = f = _PullbackEnergy(f, tuple(layout), sdim)

        B = tuple(
            jnp.asarray(
                _dedup_elements(np.asarray(build_B(s, m, self.ir, gf_b))),
                dtype=dtype,
            )
            for s, m in zip(spaces, modes)
        )
        w = jnp.asarray(_dedup_elements(np.asarray(gf.w)), dtype=dtype)
        edof = tuple(jnp.asarray(s.edof, dtype=jnp.int32) for s in spaces)

        # ---- parameters: static (tabulated now) vs field-backed (traced)
        static: dict[str, jnp.ndarray] = {}
        fieldtab: dict[str, tuple] = {}
        self.field_kinds: dict[str, tuple] = {}
        ctx = QPContext(self.xq_np, ir=self.ir, mesh=mesh)
        for name, coeff in f.params.items():
            if isinstance(coeff, GridFunctionCoefficient):
                sp = coeff.space
                if sp.mesh is not self.mesh:
                    raise ValueError(
                        f"field {name!r} lives on a different mesh"
                    )
                phi = jnp.asarray(
                    sp.elem.eval(self.ir.points), dtype=self.dtype
                )
                fieldtab[name] = (
                    jnp.asarray(sp.edof, dtype=jnp.int32),
                    phi,
                )
                self.field_kinds[name] = (
                    "gf", sp.vdim, sp.ndof_scalar, sp.nd, _space_gridmeta(sp),
                )
            elif isinstance(coeff, ScalarFieldCoefficient):
                self.field_kinds[name] = ("scalar", coeff.size)
            else:
                vals = _dedup_elements(np.asarray(coeff.eval_qp(ctx)))
                static[name] = jnp.asarray(vals, dtype=self.dtype)

        if self.pullback:
            # per-qp inverse Jacobian, row-major [m, k] — the
            # _PullbackEnergy geometry input (constant over qp on affine
            # elements, element-varying on perturbed/curved ones)
            static["_invj"] = jnp.asarray(
                np.ascontiguousarray(gf.invj).reshape(
                    -1, self.nq, sdim * sdim
                ),
                dtype=self.dtype,
            )

        self.tables = {
            "B": B,
            "w": w,
            "edof": edof,
            "static": static,
            "field": fieldtab,
        }
        # unstructured H1 spaces: transpose edof map for the gather+sum
        # scatter (see _edof_inverse)
        einv = {}
        for si, sp in enumerate(self.spaces):
            if self._gridmeta[si] is None:
                einv[si] = jnp.asarray(
                    _edof_inverse(np.asarray(sp.edof), sp.ndof_scalar)
                )
        self.tables["einv"] = einv

        # ---- matmul forms of the contractions (element-shared B only).
        # Per-qp einsums over tiny (nd, sd) dims lower to small, poorly
        # vectorized loops; folding (q, v, s) into one contraction axis turns
        #   x = B^T u, r = B g, A = B H B^T
        # into single large GEMMs against precomputed factors:
        #   R_s  [nq*w_s, nde_s]        with R[(q,a), i] = Bf[q, i, a]
        #   W_st [nq*w_s*w_t, nde_s*nde_t] = Bf_s (x) Bf_t   (A = Hflat @ W)
        # where Bf is B with the vdim block structure made explicit.
        if all(b.shape[0] == 1 for b in B):
            nb = len(spaces)
            Bf_np = []
            for s in range(nb):
                b0 = np.asarray(B[s][0])  # [nq, nd, sd]
                v, ndl, sdl = self.vdim[s], self.nd[s], self.sd[s]
                bf = np.zeros((self.nq, v * ndl, v * sdl), b0.dtype)
                for k in range(v):
                    bf[:, k * ndl : (k + 1) * ndl, k * sdl : (k + 1) * sdl] = b0
                Bf_np.append(bf)
            self.tables["R"] = tuple(
                jnp.asarray(
                    bf.transpose(0, 2, 1).reshape(-1, bf.shape[1]), dtype=dtype
                )
                for bf in Bf_np
            )
            # Blocked factors: Bf is block-diagonal in vdim (one b0 copy per
            # component), so contracting against b0 (x) b0 instead of
            # Bf (x) Bf does the identical sum with vdim_s*vdim_t fewer
            # FLOPs (4x in 2D, 9x in 3D vector problems) while staying one
            # large GEMM — the vdim axes ride the GEMM M dimension.
            #   R0_s [nq*sd_s, nd_s]               (interp/residual factor)
            #   W0_st [nq*sd_s*sd_t, nd_s*nd_t]    (A = Hblk @ W0)
            # Routing is by a padded-tile cost model, not raw FLOPs: with
            # K and N rounded up to 128-wide tiles, a blocked GEMM whose
            # K/N fall far below a tile can cost MORE than the full-Bf GEMM
            # despite vdim^2 fewer FLOPs (W0 at Q1/2D/vdim=2: K=36, N=16 vs
            # the full W's K=144, N=64).  A factor is only installed where
            # the model says it wins; the compute methods prefer blocked >
            # full > einsum among installed keys.  The model's gates have
            # no GPU measurement yet.
            def tile_cost(m_mult, k, n):
                ru = lambda x: -(-x // 128) * 128  # noqa: E731
                return m_mult * ru(k) * ru(n)

            R0 = []
            for s in range(nb):
                v, nd, sdl = self.vdim[s], self.nd[s], self.sd[s]
                blocked = tile_cost(v, self.nq * sdl, nd)
                full = tile_cost(1, self.nq * sdl * v, nd * v)
                if v > 1 and blocked >= full:
                    R0 = None  # one flag for all spaces: keep keys uniform
                    break
                R0.append(
                    jnp.asarray(
                        np.asarray(B[s][0]).transpose(0, 2, 1).reshape(
                            -1, nd
                        ),
                        dtype=dtype,
                    )
                )
            if R0 is not None:
                self.tables["R0"] = tuple(R0)
            # D0_s [nq*sd*sd, nd]: per-dof diagonal factor
            # D0[(q,a,b), d] = b0[q,d,a] b0[q,d,b] — turns the Jacobi-
            # diagonal triple contraction into one GEMM.
            self.tables["D0"] = tuple(
                jnp.asarray(
                    np.einsum(
                        "qda,qdb->qabd",
                        np.asarray(B[s][0]),
                        np.asarray(B[s][0]),
                    ).reshape(-1, self.nd[s]),
                    dtype=dtype,
                )
                for s in range(nb)
            )
            # Two contraction factors compete per (test, trial) pair; the
            # padded-tile cost model installs W0 only where it beats the
            # full-W GEMM:
            #   W0   blocked b0 (x) b0 — vdim axes ride the GEMM M dim; on
            #        the symmetric diagonal pair (s == t_) only the upper
            #        vdim-block triangle is contracted and the lower is the
            #        transpose (M multiplier vs*vt -> vs(vs+1)/2).
            #   W    full Bf (x) Bf.
            # A third candidate was rejected: a symmetry-compacted full
            # factor A = Hsym @ Wsym over the (q, a <= b) Hessian triangle
            # (K = nq*w(w+1)/2).  Its triangle extraction is a minor-dim
            # relayout of the whole Hq intermediate, which costs more than
            # the smaller GEMM saves.
            W0d = {}
            for s in range(nb):
                for t_ in range(nb):
                    vs, vt = self.vdim[s], self.vdim[t_]
                    sds, sdt = self.sd[s], self.sd[t_]
                    nds, ndt = self.nd[s], self.nd[t_]
                    ws, wt = self.widths[s], self.widths[t_]
                    ns, nt = vs * nds, vt * ndt
                    diag = s == t_
                    if self.nq * sds * sdt * nds * ndt > 32_000_000:
                        continue  # fall back to the einsum path
                    # vdim-mirror only at vdim >= 3 (9 -> 6 rows); at
                    # vdim=2 the stack/concat relayout outweighs the
                    # 4 -> 3 row cut
                    m_mult = (
                        vs * (vs + 1) // 2
                        if diag and vs >= 3 and not self.vector_fn
                        else vs * vt
                    )
                    blocked = tile_cost(m_mult, self.nq * sds * sdt,
                                        nds * ndt)
                    full_fits = self.nq * ws * wt * ns * nt <= 16_000_000
                    if full_fits and blocked >= tile_cost(
                        1, self.nq * ws * wt, ns * nt
                    ):
                        continue  # the full-W GEMM tiles better
                    b0s = np.asarray(B[s][0])
                    b0t = np.asarray(B[t_][0])
                    W0 = np.einsum("qia,qjb->qabij", b0s, b0t).reshape(
                        self.nq * sds * sdt, nds * ndt
                    )
                    W0d[f"{s}_{t_}"] = jnp.asarray(W0, dtype=dtype)
            self.tables["W0"] = W0d
            # Plane-major contraction factor (W0p) for the _elmat_planar
            # route (3D): W0 re-sliced per (a, b) shape-derivative pair,
            # [sds*sdt, nq, nds*ndt] — the batched-GEMM form that
            # contracts the Hessian in its natural (n, m)-major layout.
            W0pd = {}
            for keyst, W0arr in W0d.items():
                s, t_ = (int(c) for c in keyst.split("_"))
                sds, sdt = self.sd[s], self.sd[t_]
                if min(sds, sdt) < 3 or self.vector_fn:
                    continue
                nds_, ndt_ = self.nd[s], self.nd[t_]
                W0np = np.asarray(W0arr).reshape(
                    self.nq, sds, sdt, nds_ * ndt_
                )
                W0pd[keyst] = jnp.asarray(
                    np.transpose(W0np, (1, 2, 0, 3)).reshape(
                        sds * sdt, self.nq, nds_ * ndt_
                    ),
                    dtype=dtype,
                )
            self.tables["W0p"] = W0pd
            # Full-Bf W factor: the A = Hflat @ W route of element_matrices
            # for pairs where the blocked W0 factor was not installed.
            Wd = {}
            for s in range(nb):
                for t_ in range(nb):
                    ws, wt = self.widths[s], self.widths[t_]
                    ns = self.vdim[s] * self.nd[s]
                    nt = self.vdim[t_] * self.nd[t_]
                    if self.nq * ws * wt * ns * nt > 16_000_000:
                        continue  # fall back to the einsum path
                    Wst = np.einsum(
                        "qia,qjb->qabij", Bf_np[s], Bf_np[t_]
                    ).reshape(self.nq * ws * wt, ns * nt)
                    Wd[f"{s}_{t_}"] = jnp.asarray(Wst, dtype=dtype)
            self.tables["W"] = Wd

    # ------------------------------------------------------------------
    # core compute (pure in `tables`; safe to call inside shard_map)
    #
    # ``fast`` selects the dof-exchange path:
    #   True              gather-free strided slices / dilated pads
    #   False             generic edof gather / scatter-add
    #   ("shard", ax, K)  sharded fast path (inside shard_map over a K-way
    #                     element axis named ``ax``): dof vectors are
    #                     replicated, so each shard runs the full
    #                     strided-slice gather (bandwidth-only) and
    #                     dynamic-slices its contiguous element chunk by
    #                     lax.axis_index; scatter embeds the chunk into the
    #                     full element range and runs the dilated-pad
    #                     scatter — one caller-side psum completes assembly.
    #                     Pad-tolerant: when ne % K != 0 the gather copy-
    #                     pads the element range and the scatter trims the
    #                     tail, so arbitrary element counts keep the
    #                     band-contiguous slicing (round 3; equality-
    #                     tested by test_sharded_assembly_nondivisible_*).
    # ------------------------------------------------------------------
    def _gather_any(self, u, meta, vdim, nd, nds, edof, fast):
        if isinstance(fast, tuple) and fast[0] == "halo":
            # Distributed owner-zero layout (parallel.HaloShardedForm):
            # ``u`` is this shard's LOCAL dof block.  L2 blocks are
            # element-local (pure reshape, zero comms); h1-type blocks
            # ppermute ONE interface dof plane from the next shard into
            # the ghost plane, then run the ordinary strided-slice gather
            # on the local grid — O(surface) exchange instead of the
            # replicated path's O(ndof) psum (SURVEY §2.8, hypre true-dof
            # semantics, reference tools.hpp:179-198).
            _, axis, K = fast
            if meta is None:
                raise ValueError("halo mode requires structured grid meta")
            if meta[0] == "l2":
                return u.reshape(vdim, -1, nd).transpose(1, 2, 0)
            lmeta = _halo_local_meta(meta, K)
            U = u.reshape((vdim,) + tuple(lmeta[2]))
            incoming = jax.lax.ppermute(
                U[:, 0], axis, _halo_perm_bwd(K)
            )  # shard k receives shard k+1's first (owned) plane
            U = U.at[:, -1].add(incoming)  # ghost plane was zero
            return _fast_gather(U.reshape(-1), lmeta, vdim, nd)
        if isinstance(fast, tuple):
            _, axis, K = fast
            ue = _fast_gather(u, meta, vdim, nd)
            if ue is not None:
                ne_true = ue.shape[0]
                ne_local = -(-ne_true // K)
                pad = ne_local * K - ne_true
                if pad:
                    # non-divisible element count: extend the band with
                    # copies of element 0 — matching padded_tables'
                    # copy-pad (zero quadrature weight kills their
                    # contributions; copies keep the energy evaluation
                    # inside the function's domain)
                    ue = jnp.concatenate(
                        [ue, jnp.broadcast_to(
                            ue[:1], (pad,) + ue.shape[1:]
                        )], axis=0,
                    )
                k = jax.lax.axis_index(axis)
                return jax.lax.dynamic_slice_in_dim(
                    ue, k * ne_local, ne_local, axis=0
                )
            fast = False  # generic gather with the local edof shard
        if fast:
            ue = _fast_gather(u, meta, vdim, nd)
            if ue is not None:
                return ue
        # generic gather, row form: index the nds axis of [vdim, nds]
        # (vdim values per index) rather than scalar-indexing the flat
        # byNODES vector
        ue = u.reshape(vdim, nds)[:, edof]  # [vdim, ne, nd]
        return ue.transpose(1, 2, 0)

    def _scatter_any(self, re, meta, vdim, nd, nds, ndof, edof, fast,
                     inv=None):
        if isinstance(fast, tuple) and fast[0] == "halo":
            # adjoint of the halo gather: local dilated-pad scatter, then
            # ppermute the ghost-plane contribution to its owner (next
            # shard's first plane) and re-zero the ghost — the output
            # stays in the owner-zero layout.
            _, axis, K = fast
            if meta[0] == "l2":
                return re.transpose(2, 0, 1).reshape(-1)
            lmeta = _halo_local_meta(meta, K)
            G = _fast_scatter(re, lmeta, vdim, nd).reshape(
                (vdim,) + tuple(lmeta[2])
            )
            recv = jax.lax.ppermute(G[:, -1], axis, _halo_perm_fwd(K))
            G = G.at[:, 0].add(recv)
            last = jax.lax.axis_index(axis) == K - 1
            ghost = jnp.where(last, G[:, -1], jnp.zeros_like(G[:, -1]))
            return G.at[:, -1].set(ghost).reshape(-1)
        if isinstance(fast, tuple):
            _, axis, K = fast
            if meta is not None:
                ne_local = re.shape[0]
                k = jax.lax.axis_index(axis)
                full = jnp.zeros(
                    (ne_local * K,) + re.shape[1:], dtype=re.dtype
                )
                full = jax.lax.dynamic_update_slice_in_dim(
                    full, re, k * ne_local, axis=0
                )
                ne_true = _meta_ne(meta, nds, nd)
                if full.shape[0] != ne_true:
                    # drop the copy-pad tail (its w=0 values are zero)
                    full = full[:ne_true]
                return _fast_scatter(full, meta, vdim, nd)
            if inv is not None:
                # unstructured shard mode: place the local chunk into a
                # full-length zero element array (same pattern as the
                # structured branch above), then run the transpose-gather
                # locally; the caller's psum over shards completes the
                # sum.  The sentinel index (ne_true*nd) lands either on
                # the appended zero row or on a zero copy-pad slot.
                ne_local = re.shape[0]
                k = jax.lax.axis_index(axis)
                full = jnp.zeros(
                    (ne_local * K,) + re.shape[1:], dtype=re.dtype
                )
                full = jax.lax.dynamic_update_slice_in_dim(
                    full, re, k * ne_local, axis=0
                )
                flat = full.reshape(-1, vdim)
                padded = jnp.concatenate(
                    [flat, jnp.zeros((1, vdim), re.dtype)], axis=0
                )
                r = padded[inv].sum(axis=1)  # [nds, vdim]
                return r.T.reshape(-1)
            fast = False
        if fast:
            out = _fast_scatter(re, meta, vdim, nd)
            if out is not None:
                return out
            if inv is not None:
                # unstructured transpose-gather scatter: every dof sums
                # its incident element slots (static valence axis) — a
                # gather + reduction instead of a serialized scatter-add
                flat = re.reshape(-1, vdim)  # [ne*nd, vdim]
                padded = jnp.concatenate(
                    [flat, jnp.zeros((1, vdim), re.dtype)], axis=0
                )
                r = padded[inv].sum(axis=1)  # [nds, vdim]
                return r.T.reshape(-1)  # byNODES
        idx = edof[:, :, None] + jnp.arange(vdim) * nds
        out = jnp.zeros(ndof, dtype=re.dtype)
        return out.at[idx].add(re)

    def eval_params(self, fields: dict, tables=None, fast: bool = True) -> dict:
        t = tables or self.tables
        ne, nq = _ne_nq(t)
        if isinstance(fast, tuple) and fast[0] == "halo":
            # field vectors stay REPLICATED in halo mode (they change once
            # per outer iteration, outside the Krylov hot loop); gather
            # them with the replicated shard mode
            fast = ("shard",) + tuple(fast[1:])
        p = dict(t["static"])
        for name, kind in self.field_kinds.items():
            if name not in fields:
                raise KeyError(
                    f"assembly requires field {name!r}; got {list(fields)}"
                )
            if kind[0] == "gf":
                _, vdim, nsc, nd_f, meta = kind
                edof, phi = t["field"][name]
                u = jnp.asarray(fields[name], dtype=self.dtype)
                ue = self._gather_any(
                    u, meta, vdim, nd_f, nsc, edof, fast
                )  # [ne, nd, vdim]
                p[name] = jnp.einsum("qd,edv->eqv", phi, ue)
            else:
                _, size = kind
                v = jnp.atleast_1d(jnp.asarray(fields[name], dtype=self.dtype))
                p[name] = jnp.broadcast_to(v, (ne, nq, size))
        # element-shared static values broadcast lazily (free in XLA)
        for name, v in p.items():
            if v.shape[0] == 1 and ne > 1:
                p[name] = jnp.broadcast_to(v, (ne,) + v.shape[1:])
        return p

    def gather(self, s: int, u, tables=None, fast: bool = True):
        """Element dofs of block s: [ne, nd, vdim] (byNODES layout).

        ``fast=True`` (single-device tables) uses the gather-free paths:
        L2 dofs are element-contiguous (pure reshape); structured H1 dofs
        are lexicographic, so each element node (a, b[, c]) is a strided
        slice of the dof grid: contiguous reads instead of an index
        gather.  ``fast=False`` (sharded tables, where each
        device holds an element subset) uses the generic edof gather.
        """
        t = tables or self.tables
        u = jnp.asarray(u, dtype=self.dtype)
        return self._gather_any(
            u, self._gridmeta[s], self.vdim[s], self.nd[s], self.nds[s],
            t["edof"][s], fast,
        )

    def scatter(self, s: int, re, tables=None, fast: bool = True):
        """Scatter-add element values [ne, nd, vdim] into block-s dofs.

        Fast paths mirror ``gather``: L2 is a reshape; structured H1 sums
        interior-dilated pads (lax.pad with interior padding = the exact
        inverse of a strided slice) — no scatter op, fully vectorized.
        """
        t = tables or self.tables
        return self._scatter_any(
            re, self._gridmeta[s], self.vdim[s], self.nd[s], self.nds[s],
            self.spaces[s].ndof, t["edof"][s], fast,
            inv=t.get("einv", {}).get(s),
        )

    def x_qp(self, ublocks, tables=None, fast: bool = True) -> jnp.ndarray:
        """Stacked per-qp input x [ne, nq, n_input] (x = B^T u per space,
        component-major within a space — ad_intg.hpp:242,:304)."""
        t = tables or self.tables
        ne, nq = _ne_nq(t)
        xs = []
        for s in range(len(self.spaces)):
            ue = self.gather(s, ublocks[s], t, fast)
            if "R0" in t:
                v, nd, sd = self.vdim[s], self.nd[s], self.sd[s]
                # [ne, nd, v] -> [ne*v, nd] @ R0^T -> [ne*v, nq*sd]
                ue2 = ue.transpose(0, 2, 1).reshape(ne * v, nd)
                x = (ue2 @ t["R0"][s].T).reshape(ne, v, nq, sd)
                x = x.transpose(0, 2, 1, 3)  # [ne, nq, v, sd] comp-major
            elif "R" in t:
                ue2 = ue.transpose(0, 2, 1).reshape(ne, -1)  # [ne, nde]
                x = ue2 @ t["R"][s].T  # [ne, nq*w] — one GEMM
            else:
                x = _x_from_u(t["B"][s], ue)
            xs.append(x.reshape(ne, nq, self.widths[s]))
        return jnp.concatenate(xs, axis=-1)

    def spread(self, g, s: int):
        """Slice the per-qp segment of space s: [ne, nq, vdim, sd]."""
        seg = g[..., self.x_off[s] : self.x_off[s + 1]]
        return seg.reshape(g.shape[0], g.shape[1], self.vdim[s], self.sd[s])

    # ------------------------------------------------------------------
    def energy(self, ublocks, fields=None, tables=None, fast: bool = True):
        if self.vector_fn:
            raise ValueError(
                "vector integrands have no scalar energy "
                "(ad_native.hpp:233-248 aliases only Gradient/Hessian)"
            )
        t = tables or self.tables
        x = self.x_qp(ublocks, t, fast)
        p = self.eval_params(fields or {}, t, fast)
        vals = qpmap(self.f.energy)(x, p)
        return jnp.sum(vals * t["w"])

    def residual(self, ublocks, fields=None, tables=None, fast: bool = True):
        """Per-block residual vectors: r_s = scatter(B_s (grad f) w).

        For a vector integrand, grad f := F(x) (the reference's aliasing,
        ad_native.hpp:233-248)."""
        t = tables or self.tables
        x = self.x_qp(ublocks, t, fast)
        p = self.eval_params(fields or {}, t, fast)
        if self.vector_fn:
            pt = self.f.function
        elif callable(self.f.gradient_closed) and _closed_enabled():
            pt = self.f.gradient_closed
        else:
            pt = jax.grad(self.f.energy)
        g = qpmap(pt)(x, p) * t["w"][..., None]
        return [
            self.scatter(s, self._re_from_g(g, s, t), t, fast)
            for s in range(len(self.spaces))
        ]

    def _re_from_g(self, g, s: int, t):
        """Element vectors [ne, nd, vdim] from weighted per-qp gradients."""
        ne = g.shape[0]
        o = self.x_off[s]
        if "R0" in t:
            v, nd, sd = self.vdim[s], self.nd[s], self.sd[s]
            nq = g.shape[1]
            gseg = g[..., o : o + self.widths[s]].reshape(ne, nq, v, sd)
            gp = gseg.transpose(0, 2, 1, 3).reshape(ne * v, nq * sd)
            re = gp @ t["R0"][s]  # [ne*v, nd] — one GEMM
            return re.reshape(ne, v, nd).transpose(0, 2, 1)
        if "R" in t:
            gf = g[..., o : o + self.widths[s]].reshape(ne, -1)  # [ne, nq*w]
            re = gf @ t["R"][s]  # [ne, nde] — one GEMM
            return re.reshape(ne, self.vdim[s], self.nd[s]).transpose(0, 2, 1)
        return _r_from_g(t["B"][s], self.spread(g, s))

    def hess_state(self, ublocks, fields=None, tables=None, fast: bool = True,
                   sym: bool = False):
        """Per-qp weighted Hessian — the Newton state.

        ``sym=False``: full Hq [ne, nq, n, n] (the assembly route input).
        ``sym=True``: packed ``SymHess`` upper triangle [ne, nq, n(n+1)/2]
        — ~1.6-1.8x less HBM traffic in every downstream Krylov matvec
        (the true hot loop of LVPP/Newton solves); the pack relayout is
        paid once per Newton direction.
        """
        t = tables or self.tables
        x = self.x_qp(ublocks, t, fast)
        p = self.eval_params(fields or {}, t, fast)
        if self.vector_fn:
            # Hessian := Jacobian dF/dx (ad_native.hpp:233-248) — not
            # symmetric in general, so never packed
            H = qpmap(jax.jacfwd(self.f.function))(x, p)
            return H * t["w"][..., None, None]
        if callable(self.f.hessian_closed) and _closed_enabled():
            # analytic Hessian of a built-in energy (golden-tested vs the
            # AD form): it cuts the per-qp FLOPs ~5-10x; off by default,
            # see _closed_enabled
            H = qpmap(self.f.hessian_closed)(x, p)
        else:
            H = qpmap(jax.jacfwd(jax.grad(self.f.energy)))(x, p)
        if not sym:
            return H * t["w"][..., None, None]
        n = self.n_input
        pairs = [(a, b) for a in range(n) for b in range(a, n)]
        # plane-major stack: each H[:, :, a, b] is a plane XLA already
        # holds contiguously ((n, m)-major output layout), so this is the
        # no-relayout packing — a minor-dim take would relay out the
        # whole state (see SymHess docstring)
        planes = jnp.stack([H[:, :, a, b] for a, b in pairs], axis=0)
        return SymHess(planes * t["w"][None], n)

    def state_spec(self, axis: str):
        """shard_map PartitionSpec pytree for this integrator's
        ``hess_state`` output under element sharding: plane-major SymHess
        leaves carry the element axis at dim 1 (P(None, axis)); full
        tensors at dim 0."""
        from jax.sharding import PartitionSpec as P

        if sym_state_default() and not self.vector_fn:
            return SymHess(P(None, axis), self.n_input)
        return P(axis)

    def hess_mult(self, Hq, vblocks, tables=None, fast: bool = True):
        """Matrix-free J v: scatter(B (Hq (B^T v))).

        ``SymHess`` state applies its triangle planes as unrolled
        full-width elementwise FMA chains over the [ne, nq] batch —
        layout-native for the plane-major state (no per-iteration
        relayout, see the SymHess docstring), n(n+1)/2 state reads per
        qp instead of n^2.
        """
        t = tables or self.tables
        xv = self.x_qp(vblocks, t, fast)
        if isinstance(Hq, SymHess):
            n = Hq.n
            pairs = [(a, b) for a in range(n) for b in range(a, n)]
            xvT = jnp.moveaxis(xv, -1, 0)  # [n, ne, nq]
            planes = Hq.planes
            acc = [None] * n
            for k, (a, b) in enumerate(pairs):
                tk = planes[k]
                ta = tk * xvT[b]
                acc[a] = ta if acc[a] is None else acc[a] + ta
                if a != b:
                    tb = tk * xvT[a]
                    acc[b] = tb if acc[b] is None else acc[b] + tb
            Hxv = jnp.stack(acc, axis=-1)  # [ne, nq, n]
        else:
            Hxv = jnp.einsum("eqnm,eqm->eqn", Hq, xv)
        return [
            self.scatter(s, self._re_from_g(Hxv, s, t), t, fast)
            for s in range(len(self.spaces))
        ]

    def diagonal(self, Hq, tables=None, fast: bool = True):
        """Per-block diagonal of the assembled Jacobian (for Jacobi PC)."""
        t = tables or self.tables
        if isinstance(Hq, SymHess):
            Hq = Hq.full()  # once per Newton direction, not per matvec
        ne, nq = _ne_nq(t)
        out = []
        for s in range(len(self.spaces)):
            o = self.x_off[s]
            blk = Hq[..., o : o + self.widths[s], o : o + self.widths[s]]
            H6 = blk.reshape(
                ne, nq, self.vdim[s], self.sd[s], self.vdim[s], self.sd[s]
            )
            Hvv = jnp.diagonal(H6, axis1=2, axis2=4)  # [ne,nq,sd,sd,vdim]
            if "D0" in t:
                v, nd, sd = self.vdim[s], self.nd[s], self.sd[s]
                Hp = Hvv.transpose(0, 4, 1, 2, 3).reshape(
                    ne * v, nq * sd * sd
                )
                D = (Hp @ t["D0"][s]).reshape(ne, v, nd).transpose(0, 2, 1)
            else:
                D = _diag_from_h(t["B"][s], Hvv)
            out.append(self.scatter(s, D, t, fast))
        return out

    def element_jacobians(self, ublocks, fields=None, tables=None,
                          fast: bool = True):
        """Dense element Jacobians A_e [ne, nde, nde] of the (0, 0) block:
        the per-qp Hessian state (``hess_state``) contracted by
        ``element_matrices``.  3D/W0 configs assemble through the
        _elmat_planar batched-GEMM route (element_matrices dispatches on
        the W0p table): the Hessian is contracted in its natural
        (n, m)-major layout, no (ne, nq)-batch transpose."""
        Hq = self.hess_state(ublocks, fields, tables, fast)
        return self.element_matrices(Hq, 0, 0, tables)

    def _elmat_planar(self, Hq, s: int, t_: int, t):
        """Plane-major assembly: one BATCHED GEMM whose batch axis is the
        (vdim-pair, shape-derivative-pair) plane index, contracting only
        over qp — the per-qp Hessian is consumed in its natural
        (n, m)-major layout (jitted AD states come back plane-major),
        with NO transpose of the (ne, nq) batch into the GEMM K
        dimension.  Full tensors slice/transpose leading plane dims
        (folds into the producer layout); SymHess states expand by a
        leading-dim plane gather.

        It skips the blocked-W0 route's ``Hp`` relayout of the whole
        state.  Gated to 3D (sd >= 3): in 2D nq is small (9 at p1) and
        the batched GEMM's short K loses to the blocked route.  Returns
        None when inapplicable (no W0p factor, 2D, or disabled via
        MFEM_AD_TPU_PLANAR_ASM=0).
        """
        key = f"{s}_{t_}"
        if key not in t.get("W0", {}):
            return None
        sds, sdt = self.sd[s], self.sd[t_]
        ne, nq = _ne_nq(t)
        # Gate: the planar batched GEMM does sds*sdt/(mirror savings)
        # MORE GEMM FLOPs than the blocked-W0 route but skips the
        # whole-state Hp relayout.  At p1/3D (nq=27) the GEMM is a small
        # share of the pass and the relayout dominates; at p>=2/3D
        # (nq >= 64) the pass is GEMM-bound and the extra FLOPs lose.
        # Gate: 3D and nq <= 32, not yet re-derived from GPU cells.
        # MFEM_AD_TPU_PLANAR_ASM=1/0 forces on/off.
        force = os.environ.get("MFEM_AD_TPU_PLANAR_ASM")
        if force == "0":
            return None
        if force != "1" and (min(sds, sdt) < 3 or nq > 32):
            return None
        vs, vt = self.vdim[s], self.vdim[t_]
        nds, ndt = self.nd[s], self.nd[t_]
        os_, ot = int(self.x_off[s]), int(self.x_off[t_])
        Wp = t.get("W0p", {}).get(key)
        if Wp is None:
            return None
        if isinstance(Hq, SymHess):
            # expand to the (plane, batch) layout by a leading-dim gather
            # of the triangle planes (no (ne, nq)-batch movement)
            expand = _tri_maps(Hq.n)[3]
            Hfull = Hq.planes[expand]  # [n*n, ne, nq]
            Hfull = Hfull.reshape(Hq.n, Hq.n, ne, nq)
            Hp = Hfull[os_ : os_ + vs * sds, ot : ot + vt * sdt]
            Hp = Hp.reshape(vs, sds, vt, sdt, ne, nq).transpose(
                0, 2, 1, 3, 4, 5
            )
        else:
            # full tensor: the (n, m)-major slice/transpose folds into the
            # producer's natural plane-major output layout
            blk = Hq[..., os_ : os_ + vs * sds, ot : ot + vt * sdt]
            H6 = blk.reshape(ne, nq, vs, sds, vt, sdt)
            Hp = jnp.transpose(H6, (2, 4, 3, 5, 0, 1))
        Hb = Hp.reshape(vs * vt, sds * sdt, ne, nq)
        Y = jnp.einsum(
            "pkeq,kqj->pkej", Hb, Wp,
            precision=jax.lax.Precision.HIGH,
        )  # batched GEMM, batch (pair, shape-deriv), no batch transpose
        A = Y.sum(axis=1)  # [vs*vt, ne, nds*ndt]
        A = A.reshape(vs, vt, ne, nds, ndt).transpose(2, 0, 3, 1, 4)
        return A.reshape(ne, vs * nds, vt * ndt)

    def element_matrices(self, Hq, s: int, t_: int, tables=None):
        """Dense element blocks A_e[(v,d),(w,k)] for pair (test s, trial t_).

        Matches the reference's block slicing + MyAddMultABt accumulation
        (ad_intg.hpp:700-727); byNODES flat layout (v*nd + d).

        Contract: for a diagonal pair (s == t_) ``Hq`` must be a true
        per-qp energy Hessian state (``hess_state`` output) — its
        diagonal block is symmetric (Schwarz) and the blocked route's
        vdim-mirror contracts only the upper vdim-block triangle.
        Off-diagonal pairs make no symmetry assumption.  ``SymHess`` state
        is expanded here (exactly symmetric by construction).
        """
        t = tables or self.tables
        A = self._elmat_planar(Hq, s, t_, t)
        if A is not None:
            return A
        if isinstance(Hq, SymHess):
            Hq = Hq.full()
        ne, nq = _ne_nq(t)
        os_, ot = self.x_off[s], self.x_off[t_]
        nde_s = self.vdim[s] * self.nd[s]
        nde_t = self.vdim[t_] * self.nd[t_]
        blk = Hq[..., os_ : os_ + self.widths[s], ot : ot + self.widths[t_]]
        key = f"{s}_{t_}"
        if key in t.get("W0", {}):
            # Blocked-W GEMM: vdim_s*vdim_t fewer FLOPs than the full
            # Bf (x) Bf contraction (the vdim axes become GEMM rows).
            # HIGH (TF32 on the GPU's tensor cores, ~1e-3 rel) suffices
            # for assembled Jacobians:
            # Newton accuracy is set by the residual path (kept at the
            # session default, HIGHEST), and inexact Jacobians only affect
            # the convergence rate.  f64 inputs ignore this hint.
            vs, vt = self.vdim[s], self.vdim[t_]
            sds, sdt = self.sd[s], self.sd[t_]
            H6 = blk.reshape(ne, nq, vs, sds, vt, sdt)
            if (
                s == t_ and vs >= 3
                and os.environ.get("MFEM_AD_TPU_CHECK") == "1"
            ):
                # debug-mode guard (ADVICE r3): the mirror route below
                # contracts only the upper vdim-block triangle and relies
                # on Schwarz symmetry of the diagonal pair; a caller-built
                # asymmetric state would get silently wrong lower blocks.
                asym = jnp.max(
                    jnp.abs(H6 - H6.transpose(0, 1, 4, 5, 2, 3))
                )
                scale = jnp.maximum(jnp.max(jnp.abs(H6)), 1e-30)
                jax.debug.callback(
                    lambda a, s_: (
                        print(
                            "[mfem_ad_tpu] WARNING: asymmetric diagonal "
                            f"Hessian block (rel {a / s_:.2e}) fed to the "
                            "vdim-mirror assembly route"
                        )
                        if a > 1e-8 * s_
                        else None
                    ),
                    asym, scale,
                )
            if s == t_ and vs >= 3 and not self.vector_fn:
                # vdim-block mirror: the diagonal pair's Hessian block is
                # symmetric under the joint (v,a)<->(w,b) swap, so only
                # the upper vdim-block triangle is contracted
                # (vs*vt -> vs(vs+1)/2 GEMM rows) and
                # A[(w,j),(v,i)] = A[(v,i),(w,j)] fills the rest.
                # At vdim=2 the relayout loses — gated above.
                pairs = [
                    (a, b) for a in range(vs) for b in range(a, vs)
                ]
                Hp = jnp.stack(
                    [H6[:, :, a, :, b, :] for a, b in pairs], axis=1
                ).reshape(ne * len(pairs), nq * sds * sdt)
                Ap = jnp.einsum(
                    "ek,kj->ej", Hp, t["W0"][key],
                    precision=jax.lax.Precision.HIGH,
                ).reshape(ne, len(pairs), self.nd[s], self.nd[t_])
                blocks = [[None] * vs for _ in range(vs)]
                for k2, (a, b) in enumerate(pairs):
                    blocks[a][b] = Ap[:, k2]
                    if a != b:
                        blocks[b][a] = jnp.swapaxes(Ap[:, k2], 1, 2)
                A = jnp.concatenate(
                    [jnp.concatenate(row, axis=2) for row in blocks],
                    axis=1,
                )
                return A.reshape(ne, nde_s, nde_t)
            Hp = H6.transpose(0, 2, 4, 1, 3, 5).reshape(
                ne * vs * vt, nq * sds * sdt
            )
            A = jnp.einsum(
                "ek,kj->ej", Hp, t["W0"][key],
                precision=jax.lax.Precision.HIGH,
            )
            A = A.reshape(ne, vs, vt, self.nd[s], self.nd[t_])
            # byNODES flat layout: row (v, i) -> v*nd_s + i
            A = A.transpose(0, 1, 3, 2, 4)
            return A.reshape(ne, nde_s, nde_t)
        if key in t.get("W", {}):
            A = jnp.einsum(
                "ek,kj->ej", blk.reshape(ne, -1), t["W"][key],
                precision=jax.lax.Precision.HIGH,
            )
            return A.reshape(ne, nde_s, nde_t)
        H6 = blk.reshape(
            ne, nq, self.vdim[s], self.sd[s], self.vdim[t_], self.sd[t_]
        )
        A = _elmat_from_h(t["B"][s], t["B"][t_], H6)
        return A.reshape(ne, nde_s, nde_t)

    def assemble_dense_block(self, Hq, s: int, t_: int) -> np.ndarray:
        """Assembled dense [N_s, N_t] block (small problems / tests)."""
        Ae = np.asarray(self.element_matrices(Hq, s, t_))
        sp_s, sp_t = self.spaces[s], self.spaces[t_]
        idx_s = np.asarray(self.tables["edof"][s])[:, :, None] + np.arange(
            sp_s.vdim
        ) * sp_s.ndof_scalar  # [ne, nd, vdim]
        idx_t = np.asarray(self.tables["edof"][t_])[:, :, None] + np.arange(
            sp_t.vdim
        ) * sp_t.ndof_scalar
        # byNODES element layout: flat (v, d) = v*nd + d
        ne = Ae.shape[0]
        gi = np.transpose(idx_s, (0, 2, 1)).reshape(ne, -1)
        gj = np.transpose(idx_t, (0, 2, 1)).reshape(ne, -1)
        A = np.zeros((sp_s.ndof, sp_t.ndof))
        np.add.at(A, (gi[:, :, None], gj[:, None, :]), Ae)
        return A

    # ------------------------------------------------------------------
    def padded_tables(self, n_shards: int):
        """Copy-pad the element axis to a multiple of ``n_shards``.

        Padded elements replicate element 0 with zero quadrature weight, so
        every contribution vanishes while the energy evaluation stays in the
        function's domain (no NaN from out-of-domain zero inputs).
        """
        t = self.tables
        ne = _ne_nq(t)[0]
        pad = (-ne) % n_shards
        if pad == 0:
            return t

        def padel(a):
            if a.shape[0] == 1:  # element-shared table: leave replicated
                return a
            rep = jnp.repeat(a[:1], pad, axis=0)
            return jnp.concatenate([a, rep], axis=0)

        # zero-weight padding requires per-element w: materialize a shared
        # [1, nq] table before padding
        w_full = jnp.broadcast_to(t["w"], (ne, t["w"].shape[1]))
        w = jnp.concatenate(
            [w_full, jnp.zeros((pad, w_full.shape[1]), w_full.dtype)], axis=0
        )
        out = {
            "B": tuple(padel(b) for b in t["B"]),
            "w": w,
            "edof": tuple(padel(e) for e in t["edof"]),
            "static": {k: padel(v) for k, v in t["static"].items()},
            "field": {
                k: (padel(ed), phi) for k, (ed, phi) in t["field"].items()
            },
        }
        # shared/per-dof tables: replicate as-is.  W0p keeps the planar 3D
        # assembly route; einv keeps the unstructured transpose-gather
        # scatter (its flat indices target the TRUE element slots, and the
        # copy-padded tail carries zero-weight contributions, so the map
        # stays exact on padded tables).
        for k in ("R", "R0", "D0", "W", "W0", "W0p", "einv"):
            if k in t:
                out[k] = t[k]
        return out
