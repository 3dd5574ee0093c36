"""DOF-level proximal Galerkin — reference src/{_dof_pg,dof_pg}.hpp.

The "DOF" variant applies the entropy coupling pointwise at the FE **nodal
points** instead of at quadrature points (dof_pg.hpp:49,113,210), which
makes every coupling block diagonal:

- primal residual += (psi_j - psi_k_j) w_j / alpha      (dof_pg.hpp:124)
- dual residual    = (u_j - dE*(psi_j)) w_j / alpha     (dof_pg.hpp:125)
- Jacobian: dual-dual diag(-E*''(psi_j) w_j / alpha), primal-dual and
  dual-primal diag(w_j / alpha)                          (dof_pg.hpp:226-228)

The objective f(u) is delegated to the ordinary block integrator on the
primal spaces only (dof_pg.hpp:33-34,:96-97,:193-194).  Primal and dual
spaces must have identical element dof counts (dof_pg.hpp:46-48).

Nodal weights: the reference uses ``fe.GetNodes()`` integration-point
weights; here w_j = detJ(node_j) * wref_j with wref_j = ∫ φ_j the
interpolatory (lumped/GLL) quadrature weight of node j — the well-defined
batched realization of nodal quadrature.

``DofPGIntegrator`` implements the same integrator protocol as
``ADBlockIntegrator`` (residual/hess_state/hess_mult/diagonal/
element_matrices over explicit ``tables``), so it plugs into
``BlockNonlinearForm`` and ``parallel.ShardedForm`` unchanged.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .adeval import ADEval
from .basis import ref_element
from .coefficients import GridFunctionCoefficient, ScalarFieldCoefficient
from .fespace import FESpace
from .geometry import geom_factors
from .coefficients import QPContext
from .integrator import ADBlockIntegrator
from .pg import ADEntropy
from .quadrature import IntegrationRule, get_rule


def _nodal_weights(space: FESpace) -> np.ndarray:
    """Interpolatory nodal quadrature weights wref_j = ∫_ref φ_j."""
    ir = get_rule(space.mesh.geom, 2 * space.order + 2)
    phi = space.elem.eval(ir.points)  # [nq, nd]
    return ir.weights @ phi  # [nd]


class DofPGIntegrator:
    """Nodal PG coupling for (primal, dual) space pairs + delegated objective.

    Args:
        objective: ADFunction on the primal spaces' stacked input.
        primal_spaces, primal_modes: as for ADBlockIntegrator.
        dual_spaces: one per primal space, same element dof count, scalar.
        entropies: one scalar ADEntropy per pair.
    """

    def __init__(
        self,
        objective,
        primal_spaces,
        primal_modes,
        dual_spaces,
        entropies,
        ir_order=None,
        dtype=None,
    ):
        if isinstance(primal_spaces, FESpace):
            primal_spaces = [primal_spaces]
        if isinstance(primal_modes, ADEval):
            primal_modes = [primal_modes]
        if isinstance(dual_spaces, FESpace):
            dual_spaces = [dual_spaces]
        if isinstance(entropies, ADEntropy):
            entropies = [entropies]
        assert len(primal_spaces) == len(dual_spaces) == len(entropies), (
            "all primal spaces must have an associated dual space "
            "(dof_pg.hpp:16-18)"
        )
        self.inner = ADBlockIntegrator(
            objective, primal_spaces, primal_modes, ir_order=ir_order,
            dtype=dtype,
        )
        self.dtype = self.inner.dtype
        self.primal_spaces = list(primal_spaces)
        self.dual_spaces = list(dual_spaces)
        self.entropies = list(entropies)
        self.spaces = self.primal_spaces + self.dual_spaces
        self.np_ = len(primal_spaces)
        mesh = primal_spaces[0].mesh

        wn, edof_p, edof_d, nodes_xq = [], [], [], []
        for ps, ds, e in zip(primal_spaces, dual_spaces, entropies):
            if ps.nd != ds.nd:
                raise ValueError(
                    "primal and dual elements must have the same dof count "
                    f"({ps.nd} != {ds.nd}) — dof_pg.hpp:46-48"
                )
            if ds.vdim != ps.vdim:
                raise ValueError(
                    "DofPG coupling pairs components pointwise: primal and "
                    f"dual vdim must match ({ps.vdim} != {ds.vdim})"
                )
            if e.n_input != ps.vdim:
                raise ValueError(
                    f"entropy n_input={e.n_input} must equal the pair's "
                    f"vdim={ps.vdim} (one nodal vector per node)"
                )
            nodes = ps.elem.nodes
            ir_nodes = IntegrationRule(mesh.geom, nodes, np.zeros(len(nodes)))
            gfac = geom_factors(mesh, ir_nodes)
            wref = _nodal_weights(ps)
            wn.append(
                jnp.asarray(gfac.detj * wref[None, :], dtype=self.dtype)
            )
            nodes_xq.append(gfac.xq)
            edof_p.append(jnp.asarray(ps.edof, dtype=jnp.int32))
            edof_d.append(jnp.asarray(ds.edof, dtype=jnp.int32))

        # entropy parameters at the nodal points.  Constant/function
        # coefficients tabulate now; GridFunction-backed ones (the
        # reference's Coefficient-valued bounds, pg.hpp:281-322) tabulate
        # their basis at the nodal points and are interpolated from the
        # runtime field vector on every call — same no-retrace design as
        # the inner integrator's Evaluator fields.
        static = []
        efield = []
        self._efield_names: list[dict] = []
        for i, (e, xq) in enumerate(zip(entropies, nodes_xq)):
            ctx = QPContext(xq)
            p = {}
            ftab = {}
            efnames: dict[str, str] = {}
            for name, coeff in e.params.items():
                if isinstance(coeff, GridFunctionCoefficient):
                    sp = coeff.space
                    if sp.mesh is not mesh:
                        raise ValueError(
                            f"entropy field {name!r} lives on another mesh"
                        )
                    # nodal points of THIS pair's primal element, on the
                    # param space's basis: phi [nd_nodes, nd_param]
                    phi = jnp.asarray(
                        sp.elem.eval(primal_spaces[i].elem.nodes),
                        dtype=self.dtype,
                    )
                    ftab[name] = (
                        jnp.asarray(sp.edof, dtype=jnp.int32),
                        phi,
                    )
                    efnames[name] = (
                        "gf", coeff.name, sp.vdim, sp.ndof_scalar,
                    )
                elif isinstance(coeff, ScalarFieldCoefficient):
                    efnames[name] = ("scalar", coeff.name, coeff.size, 0)
                else:
                    p[name] = jnp.asarray(
                        coeff.eval_qp(ctx), dtype=self.dtype
                    )
            static.append(p)
            efield.append(ftab)
            self._efield_names.append(efnames)

        self.tables = {
            "inner": self.inner.tables,
            "wn": tuple(wn),
            "edof_p": tuple(edof_p),
            "edof_d": tuple(edof_d),
            "static": tuple(static),
            "efield": tuple(efield),
        }
        self.field_kinds = dict(self.inner.field_kinds)

    # -- helpers ---------------------------------------------------------
    def _gather_pair(self, i, ub, t, dual: bool):
        """Nodal values [ne, nd, v] of a pair's flat byNODES dof block."""
        sp = (self.dual_spaces if dual else self.primal_spaces)[i]
        ed = t["edof_d" if dual else "edof_p"][i]
        ub = jnp.asarray(ub, dtype=self.dtype)
        if sp.vdim == 1:
            return ub[ed][..., None]
        return ub.reshape(sp.vdim, sp.ndof_scalar)[:, ed].transpose(1, 2, 0)

    def _scatter_pair(self, i, re, t, dual: bool):
        """Adjoint of ``_gather_pair``: [ne, nd, v] -> flat [v*nds]."""
        sp = (self.dual_spaces if dual else self.primal_spaces)[i]
        ed = t["edof_d" if dual else "edof_p"][i]
        v, nds = sp.vdim, sp.ndof_scalar
        out = jnp.zeros((v, nds), re.dtype).at[:, ed].add(
            re.transpose(2, 0, 1)
        )
        return out.reshape(-1)

    def _latent_k_nodes(self, i, fields, t):
        return self._gather_pair(i, fields[f"latent_k{i}"], t, dual=True)

    def _entropy_params_nodes(self, i, fields, t):
        """Per-node entropy parameter dict, leaves [ne, nd, k]: static
        tabulations merged with runtime-field interpolations (the
        reference's Coefficient-valued entropy params, pg.hpp:281-322)."""
        p = dict(t["static"][i])
        ne, nd = t["wn"][i].shape
        for name, (kind, fname, pv, pnds) in self._efield_names[i].items():
            val = jnp.asarray(fields[fname], dtype=self.dtype)
            if kind == "scalar":
                p[name] = jnp.broadcast_to(
                    val.reshape(-1), (ne, nd, max(pv, 1))
                )
                continue
            ed, phi = t["efield"][i][name]
            ue = val.reshape(pv, pnds)[:, ed]  # [pv, ne, nd_param]
            p[name] = jnp.einsum("jd,ved->evj", phi, ue).transpose(0, 2, 1)
        return p

    def _entropy_d(self, i, psi, fields, t):
        """E*', E*'' at nodal psi vectors [ne, nd, v]."""
        e = self.entropies[i]
        p = self._entropy_params_nodes(i, fields, t)
        d1 = jax.vmap(jax.vmap(jax.grad(e.energy)))(psi, p)
        d2 = jax.vmap(jax.vmap(jax.jacfwd(jax.grad(e.energy))))(psi, p)
        return d1, d2  # [ne, nd, v], [ne, nd, v, v]

    def _alpha(self, fields):
        return jnp.asarray(fields["alpha"], dtype=self.dtype)

    # -- integrator protocol ----------------------------------------------
    def energy(self, ublocks, fields=None, tables=None, fast: bool = True):
        t = tables or self.tables
        fields = fields or {}
        e = self.inner.energy(ublocks[: self.np_], fields, t["inner"], fast)
        alpha = self._alpha(fields)
        pg = 0.0
        for i in range(self.np_):
            u = self._gather_pair(i, ublocks[i], t, dual=False)
            psi = self._gather_pair(i, ublocks[self.np_ + i], t, dual=True)
            psik = self._latent_k_nodes(i, fields, t)
            p = self._entropy_params_nodes(i, fields, t)
            estar = jax.vmap(jax.vmap(self.entropies[i].energy))(psi, p)
            cross = jnp.sum(u * (psi - psik), axis=-1)
            pg = pg + jnp.sum((cross - estar) * t["wn"][i])
        return e + pg / alpha

    def residual(self, ublocks, fields=None, tables=None, fast: bool = True):
        t = tables or self.tables
        fields = fields or {}
        rs = self.inner.residual(ublocks[: self.np_], fields, t["inner"], fast)
        alpha = self._alpha(fields)
        out_d = []
        for i in range(self.np_):
            w = (t["wn"][i] / alpha)[..., None]
            u = self._gather_pair(i, ublocks[i], t, dual=False)
            psi = self._gather_pair(i, ublocks[self.np_ + i], t, dual=True)
            psik = self._latent_k_nodes(i, fields, t)
            d1, _ = self._entropy_d(i, psi, fields, t)
            rp = (psi - psik) * w  # [ne, nd, v] into primal dofs
            rd = (u - d1) * w
            rs[i] = rs[i] + self._scatter_pair(i, rp, t, dual=False)
            out_d.append(self._scatter_pair(i, rd, t, dual=True))
        return rs + out_d

    def hess_state(self, ublocks, fields=None, tables=None, fast: bool = True,
                   sym: bool = False):
        t = tables or self.tables
        fields = fields or {}
        Hq = self.inner.hess_state(
            ublocks[: self.np_], fields, t["inner"], fast, sym=sym
        )
        alpha = self._alpha(fields)
        d2s = []
        for i in range(self.np_):
            psi = self._gather_pair(i, ublocks[self.np_ + i], t, dual=True)
            _, d2 = self._entropy_d(i, psi, fields, t)
            wn = t["wn"][i] / alpha  # [ne, nd]
            d2s.append((wn, -d2 * wn[..., None, None]))
        return (Hq, tuple(d2s))

    def state_spec(self, axis: str):
        """shard_map spec pytree matching ``hess_state``'s (Hq, d2s)
        output: delegate the inner state, element-leading d2s leaves."""
        from jax.sharding import PartitionSpec as P

        return (self.inner.state_spec(axis), P(axis))

    def hess_mult(self, state, vblocks, tables=None, fast: bool = True):
        t = tables or self.tables
        Hq, d2s = state
        ys = self.inner.hess_mult(Hq, vblocks[: self.np_], t["inner"], fast)
        out_d = []
        for i in range(self.np_):
            w, dd = d2s[i]  # [ne, nd], [ne, nd, v, v]
            vp = self._gather_pair(i, vblocks[i], t, dual=False)
            vd = self._gather_pair(i, vblocks[self.np_ + i], t, dual=True)
            ys[i] = ys[i] + self._scatter_pair(
                i, vd * w[..., None], t, dual=False
            )
            rd = vp * w[..., None] + jnp.einsum("envw,enw->env", dd, vd)
            out_d.append(self._scatter_pair(i, rd, t, dual=True))
        return ys + out_d

    def diagonal(self, state, tables=None, fast: bool = True):
        t = tables or self.tables
        Hq, d2s = state
        ds = self.inner.diagonal(Hq, t["inner"], fast)
        out_d = []
        for i in range(self.np_):
            _, dd = d2s[i]  # [ne, nd, v, v]
            ddiag = jnp.diagonal(dd, axis1=2, axis2=3)  # [ne, nd, v]
            out_d.append(self._scatter_pair(i, ddiag, t, dual=True))
        return ds + out_d

    def element_matrices(self, state, s, t_, tables=None):
        t = tables or self.tables
        Hq, d2s = state
        npq = self.np_

        def coupling(wvals, v):
            """[ne, nd] node weights -> [ne, v*nd, v*nd] byNODES blocks
            (node-diagonal, component-diagonal)."""
            ne, nd = wvals.shape
            D = wvals[:, :, None] * jnp.eye(nd, dtype=wvals.dtype)
            A = jnp.einsum("vw,eij->eviwj", jnp.eye(v, dtype=wvals.dtype), D)
            return A.reshape(ne, v * nd, v * nd)

        def dualdual(dd):
            """[ne, nd, v, v] -> [ne, v*nd, v*nd] node-diagonal blocks."""
            ne, nd, v, _ = dd.shape
            E = jnp.eye(nd, dtype=dd.dtype)
            A = jnp.einsum("eivw,ij->eviwj", dd, E)
            return A.reshape(ne, v * nd, v * nd)

        if s < npq and t_ < npq:
            # primal-primal has no nodal part (coupling is off-diagonal)
            return self.inner.element_matrices(Hq, s, t_, t["inner"])
        ne = t["wn"][0].shape[0]
        nde_s = self.spaces[s].nd * self.spaces[s].vdim
        nde_t = self.spaces[t_].nd * self.spaces[t_].vdim
        if s < npq and t_ >= npq:
            i = t_ - npq
            if s == i:
                return coupling(d2s[i][0], self.spaces[s].vdim)
            return jnp.zeros((ne, nde_s, nde_t))
        if s >= npq and t_ < npq:
            i = s - npq
            if t_ == i:
                return coupling(d2s[i][0], self.spaces[s].vdim)
            return jnp.zeros((ne, nde_s, nde_t))
        i, j = s - npq, t_ - npq
        if i == j:
            return dualdual(d2s[i][1])
        return jnp.zeros((ne, nde_s, nde_t))

    def assemble_dense_block(self, state, s, t_):
        Ae = np.asarray(self.element_matrices(state, s, t_))
        sp_s, sp_t = self.spaces[s], self.spaces[t_]
        tb = self.tables
        edofs = list(tb["edof_p"]) + list(tb["edof_d"])
        idx_s = np.asarray(edofs[s], dtype=np.int64)[:, :, None] + np.arange(
            sp_s.vdim
        ) * sp_s.ndof_scalar
        idx_t = np.asarray(edofs[t_], dtype=np.int64)[:, :, None] + np.arange(
            sp_t.vdim
        ) * sp_t.ndof_scalar
        ne = Ae.shape[0]
        gi = np.transpose(idx_s, (0, 2, 1)).reshape(ne, -1)
        gj = np.transpose(idx_t, (0, 2, 1)).reshape(ne, -1)
        A = np.zeros((sp_s.ndof, sp_t.ndof))
        np.add.at(A, (gi[:, :, None], gj[:, None, :]), Ae)
        return A

    def padded_tables(self, n_shards: int):
        t = self.tables
        ne = t["wn"][0].shape[0]
        pad = (-ne) % n_shards
        inner = self.inner.padded_tables(n_shards)
        if pad == 0:
            return {**t, "inner": inner}

        def padel(a):
            return jnp.concatenate([a, jnp.repeat(a[:1], pad, axis=0)], axis=0)

        def padzero(a):
            z = jnp.zeros((pad,) + a.shape[1:], a.dtype)
            return jnp.concatenate([a, z], axis=0)

        return {
            "inner": inner,
            "wn": tuple(padzero(w) for w in t["wn"]),
            "edof_p": tuple(padel(e) for e in t["edof_p"]),
            "edof_d": tuple(padel(e) for e in t["edof_d"]),
            "static": tuple(
                {k: padel(v) for k, v in p.items()} for p in t["static"]
            ),
            "efield": tuple(
                {k: (padel(ed), phi) for k, (ed, phi) in f.items()}
                for f in t["efield"]
            ),
        }
