"""ShardedForm: run a BlockNonlinearForm's assembly across a device mesh.

Parallel model (cf. reference §2.8: one strategy — mesh partitioning over
MPI):

- the **element axis** of every tabulated tensor (B, w, edof, per-qp
  parameters) is sharded over a 1-D ``jax.sharding.Mesh`` axis; elements
  are copy-padded with zero weights to a multiple of the device count;
- **dof vectors are replicated**; each device scatter-adds its elements'
  contributions into a full-length local vector and a single ``psum``
  completes assembly — this is the hypre ``ParallelAssemble`` (local->true
  reduction, ex4.cpp:119-120) realized as one ICI collective;
- Newton norms need no extra collective (vectors are replicated), matching
  the reference's allreduce-inside-NewtonSolver semantics.

``ShardedForm`` quacks like ``forms.BlockNonlinearForm``, so ``newton`` and
``PGSolver`` run unchanged on multi-device meshes.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map as _shard_map


def shard_map(f, mesh, in_specs, out_specs):
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)


_REPLICATED_TABLE_KEYS = ("R", "R0", "D0", "W", "W0", "W0p", "einv")


def _table_specs(tables, axis: str):
    """PartitionSpec pytree matching an integrator's tables bundle.

    Keyed by table role, then by shape: the precomputed contraction
    factors (R/R0/D0/W/W0) and field shape tables (phi) replicate
    unconditionally — their leading dims are quadrature-sized and can
    collide with the element count (e.g. nq*sd^2 = 64 on an 8x8 mesh,
    found round 4); for the remaining tables, a leaf whose leading dim
    equals the (padded) element count shards over ``axis`` and
    element-shared leaves (leading dim 1, integrator._dedup_elements)
    replicate.
    """
    ne = (tables["edof"][0] if "edof" in tables else tables["wn"][0]).shape[0]

    def spec(leaf):
        return P(axis) if (leaf.ndim >= 1 and leaf.shape[0] == ne) else P()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return spec(node)

    def replicate(node):
        if isinstance(node, dict):
            return {k: replicate(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(replicate(v) for v in node)
        return P()

    out = {}
    for k, v in tables.items():
        if k in _REPLICATED_TABLE_KEYS:
            out[k] = replicate(v)
        elif k == "field":
            # (edof [ne, nd] sharded, phi [nq, nd] replicated) per field
            out[k] = {
                name: (spec(ed), P()) for name, (ed, phi) in v.items()
            }
        elif k == "inner":  # DofPG nested bundle
            out[k] = _table_specs(v, axis)
        else:
            out[k] = walk(v)
    return out


class ShardedForm:
    """Element-sharded view of a BlockNonlinearForm.

    Args:
        form: a built BlockNonlinearForm (serial tables are kept for the
              dense/direct fallback).
        devices: device list (default all of ``jax.devices()``).
        axis_name: mesh axis name for the element shard.
    """

    def __init__(self, form, devices=None, axis_name: str = "elems"):
        self.form = form
        devices = list(devices if devices is not None else jax.devices())
        self.n_devices = len(devices)
        self.axis_name = axis_name
        self.mesh = Mesh(np.array(devices), (axis_name,))
        self.tables = [
            intg.padded_tables(self.n_devices) for intg in form.integrators
        ]
        self.specs = [_table_specs(t, axis_name) for t in self.tables]
        # place the tables on the device mesh (manual walk: PartitionSpec is
        # tuple-like, so jax.tree.map would descend into it)
        self.tables = [
            self._place(t, sp) for t, sp in zip(self.tables, self.specs)
        ]
        # The structured gather-free fast path runs under shard_map for ANY
        # element count: each shard runs the full strided-slice gather on
        # the replicated dof vector, extends the band with element-0 copies
        # when ne % n_devices != 0 (mirroring padded_tables' zero-weight
        # copy-pad) and dynamic-slices its contiguous chunk; the scatter
        # drops the pad tail before the dilated-pad reduction.  See
        # integrator._gather_any/_scatter_any ("shard" mode).  Unstructured
        # meshes (no grid meta) fall through to the generic edof gather
        # inside the same mode.
        self.fast = [
            ("shard", axis_name, self.n_devices)
            for intg in form.integrators
        ]
        self._jit_cache: dict[str, object] = {}
        self._ess = None

    def _place(self, t, sp):
        if isinstance(sp, P):
            if jax.process_count() > 1:
                # multi-process (multi-controller SPMD): device_put from
                # identical host arrays on every process — the supported
                # path for building process-spanning global arrays
                t = np.asarray(t)
            return jax.device_put(t, NamedSharding(self.mesh, sp))
        if isinstance(t, dict):
            return {k: self._place(t[k], sp[k]) for k in t}
        return tuple(self._place(a, b) for a, b in zip(t, sp))

    def replicate(self, x):
        """Place a (host or single-device) array replicated on the mesh —
        required for jit inputs when the mesh spans processes."""
        if jax.process_count() > 1:
            x = np.asarray(x)
        return jax.device_put(x, NamedSharding(self.mesh, P()))

    # -- mirror the BlockNonlinearForm interface -------------------------
    @property
    def spaces(self):
        return self.form.spaces

    @property
    def offsets(self):
        return self.form.offsets

    @property
    def ndof(self):
        return self.form.ndof

    @property
    def ess_mask(self):
        if self._ess is None:
            self._ess = self.replicate(self.form.ess_mask)
        return self._ess

    def split(self, u):
        return self.form.split(u)

    def _jit(self, key, fn):
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    # --------------------------------------------------------------------
    # Raw methods share the BlockNonlinearForm protocol (tables/ess passed
    # explicitly) so newton's fused step runs unchanged on either form.
    def _tables(self):
        return tuple(self.tables)

    def _state_specs(self):
        return tuple(
            intg.state_spec(self.axis_name)
            for intg in self.form.integrators
        )

    def energy_raw(self, tables, u, fields):
        def local(tables, u, fields):
            e = sum(
                intg.energy(self.form.split(u), fields, t, fast=f)
                for intg, t, f in zip(
                    self.form.integrators, tables, self.fast
                )
            )
            return jax.lax.psum(e, self.axis_name)

        return shard_map(
            local, mesh=self.mesh,
            in_specs=(tuple(self.specs), P(), P()), out_specs=P(),
        )(tables, u, fields)

    def mult_raw(self, tables, ess, u, fields):
        def local(tables, u, fields):
            acc = jnp.zeros(self.form.ndof, dtype=u.dtype)
            for intg, t, f in zip(self.form.integrators, tables, self.fast):
                rs = intg.residual(self.form.split(u), fields, t, fast=f)
                acc = acc + jnp.concatenate(rs)
            return jax.lax.psum(acc, self.axis_name)

        r = shard_map(
            local, mesh=self.mesh,
            in_specs=(tuple(self.specs), P(), P()), out_specs=P(),
        )(tables, u, fields)
        return jnp.where(ess, 0.0, r)

    def grad_state_raw(self, tables, u, fields):
        """Per-integrator per-qp Hessians, left sharded over elements."""

        from ..integrator import sym_state_default

        sym = sym_state_default()

        def local(tables, u, fields):
            return tuple(
                intg.hess_state(self.form.split(u), fields, t, fast=f,
                                sym=sym)
                for intg, t, f in zip(
                    self.form.integrators, tables, self.fast
                )
            )

        return shard_map(
            local, mesh=self.mesh,
            in_specs=(tuple(self.specs), P(), P()),
            out_specs=self._state_specs(),
        )(tables, u, fields)

    def grad_mult_raw(self, tables, ess, state, v):
        def local(tables, ess, state, v):
            acc = jnp.zeros(self.form.ndof, dtype=v.dtype)
            v0 = jnp.where(ess, 0.0, v)
            blocks = self.form.split(v0)
            for intg, t, Hq, f in zip(
                self.form.integrators, tables, state, self.fast
            ):
                ys = intg.hess_mult(Hq, blocks, t, fast=f)
                acc = acc + jnp.concatenate(ys)
            return jax.lax.psum(acc, self.axis_name)

        y = shard_map(
            local, mesh=self.mesh,
            in_specs=(tuple(self.specs), P(), self._state_specs(), P()),
            out_specs=P(),
        )(tables, ess, state, v)
        return jnp.where(ess, v, y)

    def grad_diag_raw(self, tables, ess, state):
        def local(tables, state):
            acc = jnp.zeros(self.form.ndof)
            for intg, t, Hq, f in zip(
                self.form.integrators, tables, state, self.fast
            ):
                ds = intg.diagonal(Hq, t, fast=f)
                acc = acc + jnp.concatenate(ds)
            return jax.lax.psum(acc, self.axis_name)

        d = shard_map(
            local, mesh=self.mesh,
            in_specs=(tuple(self.specs), self._state_specs()),
            out_specs=P(),
        )(tables, state)
        return jnp.where(ess, 1.0, d)

    def schur_arrays_raw(self, tables, ess, state, reg, jacobi, lumped):
        """Sharded counterpart of ``solvers._schur_arrays`` — lets the
        production Schur/GMG solver run on element-sharded forms (the
        reference's flagship is distributed MUMPS, test.sh:9,
        tools.hpp:128-154).  The element-block ops (``element_matrices``,
        node-block scatters) are shard-local by construction; one psum
        completes each global assembly and a pmax the global maxima.
        Outputs are replicated — O(dofs) preconditioner data rebuilt once
        per Newton direction, consumed by replicated ``_schur_ops``."""
        from ..solvers import _schur_arrays_core

        form = self.form
        intg = form.integrators[0]
        axis = self.axis_name
        K = self.n_devices
        ne_true = intg.tables["edof"][0].shape[0]
        fast0 = self.fast[0]

        def local(tables, ess, state):
            # global |diag(J)| — grad_diag_raw's local body
            acc = jnp.zeros(form.ndof)
            for intg_i, t_i, Hq_i, f_i in zip(
                form.integrators, tables, state, self.fast
            ):
                ds = intg_i.diagonal(Hq_i, t_i, fast=f_i)
                acc = acc + jnp.concatenate(ds)
            d_full = jnp.abs(
                jnp.where(ess, 1.0, jax.lax.psum(acc, axis))
            )

            def globalize(a):
                # element-axis chunk [ne_loc, ...] -> replicated, trimmed
                # to the true element count (drops copy-padded elements)
                ne_loc = a.shape[0]
                k = jax.lax.axis_index(axis)
                full = jnp.zeros((ne_loc * K,) + a.shape[1:], a.dtype)
                full = jax.lax.dynamic_update_slice_in_dim(
                    full, a, k * ne_loc, axis=0
                )
                return jax.lax.psum(full, axis)[:ne_true]

            return _schur_arrays_core(
                form, intg, tables[0], ess, state[0], d_full, reg, jacobi,
                lumped,
                psum=lambda x: jax.lax.psum(x, axis),
                pmax=lambda x: jax.lax.pmax(x, axis),
                globalize=globalize, fast=fast0,
            )

        keys = ["Dblk_inv", "Sig_blk_inv"] if lumped else ["De_inv"]
        if jacobi:
            keys += ["dshift", "safe"]
        return shard_map(
            local, mesh=self.mesh,
            in_specs=(tuple(self.specs), P(), self._state_specs()),
            out_specs={k: P() for k in keys},
        )(tables, ess, state)

    # -- public jitted wrappers ------------------------------------------
    def energy(self, u, fields=None):
        fn = self._jit("energy", self.energy_raw)
        return fn(self._tables(), u, fields or {})

    def mult(self, u, fields=None):
        fn = self._jit("mult", self.mult_raw)
        return fn(self._tables(), self.ess_mask, u, fields or {})

    def grad_state(self, u, fields=None):
        fn = self._jit("grad_state", self.grad_state_raw)
        return fn(self._tables(), u, fields or {})

    def grad_mult(self, state, v):
        fn = self._jit("grad_mult", self.grad_mult_raw)
        return fn(self._tables(), self.ess_mask, state, v)

    def grad_diag(self, state):
        fn = self._jit("grad_diag", self.grad_diag_raw)
        return fn(self._tables(), self.ess_mask, state)

    def assemble_dense(self, state):
        """Direct-solver fallback: gather state and use the serial path.

        The padded element axis is trimmed by the TRUE element count from
        edof (never element-deduped); ``w`` may be shared with shape
        [1, nq] on uniform meshes and must not be used for the trim.
        """
        from ..integrator import SymHess

        def trim(Hq, ne_true):
            if isinstance(Hq, SymHess):
                return SymHess(np.asarray(Hq.planes)[:, :ne_true], Hq.n)
            return np.asarray(Hq)[:ne_true]

        serial_state = [
            trim(Hq, intg.tables["edof"][0].shape[0])
            for intg, Hq in zip(self.form.integrators, state)
        ]
        return self.form.assemble_dense(serial_state)
