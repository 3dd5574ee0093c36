"""HaloShardedForm: distributed-dof assembly with interface-only exchange.

Round 4 (VERDICT r3 #2).  ``parallel.ShardedForm`` replicates dof vectors
and completes every assembly with a full-length [ndof] ``psum`` — correct,
but every Krylov iteration pays an O(ndof) ICI all-reduce and O(ndof)
memory per device.  This form implements the partition-boundary exchange SURVEY
§2.8 prescribes (the JAX realization of hypre's true-dof partitioning that
the reference inherits, tools.hpp:179-198):

- **Elements** are banded along the element-major grid axis (the same
  contiguous chunks ShardedForm uses), one band per device.
- **Dof vectors are distributed** in an *owner-zero* layout: each shard
  stores its band's dof planes plus one ghost interface plane (always held
  as zero); a dof value lives exactly once, on its owner.  Inner products
  and norms of such vectors are plain ``jnp.vdot`` — ghosts contribute
  nothing — so the Krylov stack (cg/minres/gmres/newton) runs UNCHANGED on
  global jax.Arrays sharded over the mesh axis, with XLA inserting only
  scalar all-reduces for the dots.
- **The matvec exchanges two interface dof planes per h1-type space**
  (ghost fill before the gather, owner return after the scatter) via
  ``lax.ppermute`` — O(surface) bytes, not O(ndof); L2 blocks are
  element-local and exchange nothing.

Layout of a distributed vector (length ``ndof_dist = K * slots``): the
per-shard slot vector concatenates every space's local block
``[vdim, planes_loc, rest...]`` (h1-type, ``planes_loc = n_loc*p + 1``
including the ghost) or ``[vdim, ne_loc, nd]`` (L2).  ``to_dist`` /
``from_dist`` convert to/from the canonical byNODES layout.

Requirements: structured spaces only (grid meta), outer cell count
divisible by the device count.  Use ``ShardedForm`` otherwise.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..integrator import _halo_local_meta
from .sharding import _table_specs, shard_map


def _outer_cells(meta) -> int:
    dims = meta[1]
    return dims[1] if len(dims) == 2 else dims[0]


class HaloShardedForm:
    """Element-banded, dof-distributed view of a BlockNonlinearForm."""

    def __init__(self, form, devices=None, axis_name: str = "elems"):
        self.form = form
        devices = list(devices if devices is not None else jax.devices())
        self.n_devices = K = len(devices)
        self.axis_name = axis_name
        self.mesh = Mesh(np.array(devices), (axis_name,))

        # -- per-space distributed layout ------------------------------
        if not form.integrators:
            raise ValueError("form has no integrators")
        self._meta = []
        self._lmeta = []
        self._local_shape = []  # local block shape per space
        intg0 = form.integrators[0]
        for s, sp in enumerate(form.spaces):
            meta = intg0._gridmeta[s]
            if meta is None:
                raise ValueError(
                    "HaloShardedForm requires structured spaces (grid "
                    "meta); use ShardedForm for unstructured meshes"
                )
            self._meta.append(meta)
            if meta[0] == "l2":
                ne = sp.num_elements
                if ne % K:
                    raise ValueError("element count not divisible by K")
                self._lmeta.append(("l2",))
                self._local_shape.append((sp.vdim, ne // K, sp.nd))
            else:
                if _outer_cells(meta) % K:
                    raise ValueError(
                        f"outer cell count {_outer_cells(meta)} not "
                        f"divisible by the device count {K}"
                    )
                lm = _halo_local_meta(meta, K)
                self._lmeta.append(lm)
                self._local_shape.append((sp.vdim,) + tuple(lm[2]))
        sizes = [int(np.prod(sh)) for sh in self._local_shape]
        self._loc_off = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        self.slots = int(self._loc_off[-1])
        self.ndof_dist = K * self.slots

        # element tables: identical banding to ShardedForm (ne % K == 0
        # guaranteed, so padded_tables is a no-op)
        for intg in form.integrators:
            ne = intg.tables["edof"][0].shape[0]
            if ne % K:
                raise ValueError("integrator element count not banded")
        self.tables = [intg.tables for intg in form.integrators]
        self.specs = [_table_specs(t, axis_name) for t in self.tables]
        self.tables = [
            self._place(t, sp) for t, sp in zip(self.tables, self.specs)
        ]
        self.fast = [("halo", axis_name, K) for _ in form.integrators]
        self._jit_cache: dict = {}
        self.vspec = NamedSharding(self.mesh, P(axis_name))
        self.ess_mask = jax.device_put(
            self.to_dist(np.asarray(form.ess_mask)), self.vspec
        )

    # -- layout conversion (host-side numpy) ---------------------------
    def _space_blocks(self, u, s: int):
        """Canonical space vector -> [K, *local_shape] (ghosts zeroed)."""
        sp = self.form.spaces[s]
        K = self.n_devices
        meta = self._meta[s]
        u = np.asarray(u)
        if meta[0] == "l2":
            vdim, nel, nd = self._local_shape[s]
            return u.reshape(sp.vdim, K, nel, nd).transpose(1, 0, 2, 3)
        p = meta[4]
        ndims = meta[2]
        planes_own = (ndims[0] - 1) // K
        planes_loc = planes_own + 1
        U = u.reshape((sp.vdim,) + tuple(ndims))
        out = np.zeros((K, sp.vdim, planes_loc) + tuple(ndims[1:]), u.dtype)
        for k in range(K):
            lo = k * planes_own
            out[k] = U[:, lo : lo + planes_loc]
            if k < K - 1:
                out[k, :, -1] = 0  # ghost plane: owner-zero
        return out

    def to_dist(self, u) -> np.ndarray:
        """Canonical concatenated dof vector -> distributed layout."""
        u = np.asarray(u)
        off = self.form.offsets
        per_shard = []
        blocks = [
            self._space_blocks(u[off[s] : off[s + 1]], s)
            for s in range(len(self.form.spaces))
        ]
        for k in range(self.n_devices):
            per_shard.append(
                np.concatenate([b[k].ravel() for b in blocks])
            )
        return np.concatenate(per_shard)

    def from_dist(self, ud) -> np.ndarray:
        """Distributed layout -> canonical concatenated dof vector."""
        ud = np.asarray(ud).reshape(self.n_devices, self.slots)
        off = self.form.offsets
        K = self.n_devices
        out = np.zeros(self.form.ndof, ud.dtype)
        for s, sp in enumerate(self.form.spaces):
            meta = self._meta[s]
            seg = ud[:, self._loc_off[s] : self._loc_off[s + 1]]
            if meta[0] == "l2":
                vdim, nel, nd = self._local_shape[s]
                blk = seg.reshape(K, vdim, nel, nd).transpose(1, 0, 2, 3)
                out[off[s] : off[s + 1]] = blk.reshape(-1)
                continue
            ndims = meta[2]
            planes_own = (ndims[0] - 1) // K
            U = np.zeros((sp.vdim,) + tuple(ndims), ud.dtype)
            blk = seg.reshape((K,) + self._local_shape[s])
            for k in range(K):
                lo = k * planes_own
                U[:, lo : lo + planes_own] = blk[k][:, :planes_own]
            U[:, -1] = blk[K - 1][:, -1]  # final plane: owned by last shard
            out[off[s] : off[s + 1]] = U.reshape(-1)
        return out

    def dist_array(self, u_canonical):
        """Canonical host vector -> sharded device array (solver input)."""
        return jax.device_put(self.to_dist(u_canonical), self.vspec)

    def halo_bytes_per_matvec(self) -> int:
        """Interface bytes exchanged by one grad_mult (both ppermutes,
        all shard boundaries, all h1-type spaces) — the O(surface) number
        the replicated path's O(ndof) psum is replaced by."""
        total = 0
        itemsize = np.dtype(
            np.float64 if jax.config.jax_enable_x64 else np.float32
        ).itemsize
        for s, sp in enumerate(self.form.spaces):
            meta = self._meta[s]
            if meta[0] == "l2":
                continue
            plane = sp.vdim * int(np.prod(meta[2][1:]))
            total += 2 * (self.n_devices - 1) * plane * itemsize
        return total

    # -- form protocol ---------------------------------------------------
    @property
    def spaces(self):
        return self.form.spaces

    @property
    def ndof(self):
        return self.ndof_dist

    def _place(self, t, sp):
        if isinstance(sp, P):
            return jax.device_put(t, NamedSharding(self.mesh, sp))
        if isinstance(t, dict):
            return {k: self._place(t[k], sp[k]) for k in t}
        return tuple(self._place(a, b) for a, b in zip(t, sp))

    def _jit(self, key, fn):
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(fn)
        return self._jit_cache[key]

    def _tables(self):
        return tuple(self.tables)

    def _state_specs(self):
        return tuple(
            intg.state_spec(self.axis_name)
            for intg in self.form.integrators
        )

    def split_local(self, u_loc):
        """Local slot vector [slots] -> per-space local flat blocks."""
        return [
            u_loc[self._loc_off[s] : self._loc_off[s + 1]]
            for s in range(len(self.form.spaces))
        ]

    # raw methods: pure in (tables, ess, ...), D-layout vectors in/out
    def energy_raw(self, tables, u, fields):
        def local(tables, u_loc, fields):
            blocks = self.split_local(u_loc)
            e = sum(
                intg.energy(blocks, fields, t, fast=f)
                for intg, t, f in zip(
                    self.form.integrators, tables, self.fast
                )
            )
            return jax.lax.psum(e, self.axis_name)

        return shard_map(
            local, mesh=self.mesh,
            in_specs=(tuple(self.specs), P(self.axis_name), P()),
            out_specs=P(),
        )(tables, u, fields)

    def mult_raw(self, tables, ess, u, fields):
        def local(tables, u_loc, fields):
            blocks = self.split_local(u_loc)
            outs = None
            for intg, t, f in zip(self.form.integrators, tables, self.fast):
                rs = intg.residual(blocks, fields, t, fast=f)
                r = jnp.concatenate(rs)
                outs = r if outs is None else outs + r
            return outs

        r = shard_map(
            local, mesh=self.mesh,
            in_specs=(tuple(self.specs), P(self.axis_name), P()),
            out_specs=P(self.axis_name),
        )(tables, u, fields)
        return jnp.where(ess, 0.0, r)

    def grad_state_raw(self, tables, u, fields):
        from ..integrator import sym_state_default

        sym = sym_state_default()

        def local(tables, u_loc, fields):
            blocks = self.split_local(u_loc)
            return tuple(
                intg.hess_state(blocks, fields, t, fast=f, sym=sym)
                for intg, t, f in zip(
                    self.form.integrators, tables, self.fast
                )
            )

        return shard_map(
            local, mesh=self.mesh,
            in_specs=(tuple(self.specs), P(self.axis_name), P()),
            out_specs=self._state_specs(),
        )(tables, u, fields)

    def grad_mult_raw(self, tables, ess, state, v):
        v0 = jnp.where(ess, 0.0, v)

        def local(tables, state, v_loc):
            blocks = self.split_local(v_loc)
            outs = None
            for intg, t, Hq, f in zip(
                self.form.integrators, tables, state, self.fast
            ):
                ys = intg.hess_mult(Hq, blocks, t, fast=f)
                y = jnp.concatenate(ys)
                outs = y if outs is None else outs + y
            return outs

        y = shard_map(
            local, mesh=self.mesh,
            in_specs=(
                tuple(self.specs), self._state_specs(), P(self.axis_name),
            ),
            out_specs=P(self.axis_name),
        )(tables, state, v0)
        return jnp.where(ess, v, y)

    def grad_diag_raw(self, tables, ess, state):
        def local(tables, state):
            outs = None
            for intg, t, Hq, f in zip(
                self.form.integrators, tables, state, self.fast
            ):
                ds = intg.diagonal(Hq, t, fast=f)
                d = jnp.concatenate(ds)
                outs = d if outs is None else outs + d
            return outs

        d = shard_map(
            local, mesh=self.mesh,
            in_specs=(tuple(self.specs), self._state_specs()),
            out_specs=P(self.axis_name),
        )(tables, state)
        return jnp.where(ess, 1.0, d)

    # -- distributed Schur-direction support (VERDICT r4 #2) -------------
    # The production Schur elimination (solvers._schur_solve_traced)
    # becomes layout-agnostic through these hooks: vectors here are
    # per-shard slot concatenations [K * slots], so the canonical [:n0]
    # block slicing is replaced by shard-local slot slicing under
    # shard_map (zero collectives), and the element-local L2 latent
    # inverse consumes the ELEMENT-SHARDED De_inv directly.
    @property
    def offsets(self):
        """Canonical block offsets of the underlying form (used by the
        Schur driver only for block-count validation; halo vectors are
        NOT sliceable by these)."""
        return self.form.offsets

    def _slots_u(self) -> int:
        return int(self._loc_off[len(self.form.spaces) - 1])

    def split_u_p(self, v):
        """Distributed vector -> (primal superblock, latent block), each
        in its own distributed layout (shard-local slot slicing)."""
        su = self._slots_u()

        def local(v_loc):
            return v_loc[:su], v_loc[su:]

        return shard_map(
            local, mesh=self.mesh, in_specs=P(self.axis_name),
            out_specs=(P(self.axis_name), P(self.axis_name)),
        )(v)

    def join_u_p(self, vu, wp):
        def local(a, b):
            return jnp.concatenate([a, b])

        return shard_map(
            local, mesh=self.mesh,
            in_specs=(P(self.axis_name), P(self.axis_name)),
            out_specs=P(self.axis_name),
        )(vu, wp)

    def pad_u(self, vu):
        sp = self.slots - self._slots_u()

        def local(a):
            return jnp.concatenate([a, jnp.zeros(sp, a.dtype)])

        return shard_map(
            local, mesh=self.mesh, in_specs=P(self.axis_name),
            out_specs=P(self.axis_name),
        )(vu)

    def pad_p(self, wp):
        su = self._slots_u()

        def local(b):
            return jnp.concatenate([jnp.zeros(su, b.dtype), b])

        return shard_map(
            local, mesh=self.mesh, in_specs=P(self.axis_name),
            out_specs=P(self.axis_name),
        )(wp)

    def make_latent_dinv(self, De_inv):
        """Element-local latent inverse w -> D^-1 w on the distributed
        latent block (L2 scalar latent: dofs are element-contiguous per
        shard, so the apply is a shard-local batched matvec against the
        element-sharded ``De_inv`` — zero collectives)."""
        lb = len(self.form.spaces) - 1
        sp_l = self.form.spaces[lb]
        if sp_l.fe_type != "L2" or sp_l.vdim != 1:
            raise NotImplementedError(
                "halo Schur elimination needs a scalar L2 latent block"
            )
        ndl = sp_l.nd

        def apply(wp):
            def local(De_loc, w_loc):
                we = w_loc.reshape(-1, ndl)
                ze = jnp.einsum("eij,ej->ei", De_loc, we)
                return ze.reshape(-1)

            return shard_map(
                local, mesh=self.mesh,
                in_specs=(P(self.axis_name), P(self.axis_name)),
                out_specs=P(self.axis_name),
            )(De_inv, wp)

        return apply

    def schur_arrays_raw(self, tables, ess, state, reg, jacobi, lumped):
        """Distributed counterpart of ``solvers._schur_arrays``: the
        element-block math runs shard-local (the Schur arrays shard
        exactly like the Newton state), the primal node scatter completes
        through the halo ppermute inside ``intg.scatter``, and outputs
        stay in their natural distributed/sharded layouts — no [ndof]
        collective anywhere (reference flagship: distributed MUMPS over
        hypre true-dof partitions, tools.hpp:128-154)."""
        if lumped:
            raise NotImplementedError(
                "halo Schur supports the L2-latent (exact elimination) "
                "path; use ShardedForm for lumped H1 latents"
            )
        from ..solvers import _schur_arrays_core

        form = self.form
        if len(form.spaces) != 2:
            raise NotImplementedError("halo Schur needs a 2-block form")
        intg = form.integrators[0]
        axis = self.axis_name
        su = self._slots_u()
        fast0 = self.fast[0]

        def local(tables, ess_loc, state):
            acc = None
            for intg_i, t_i, Hq_i, f_i in zip(
                form.integrators, tables, state, self.fast
            ):
                ds = intg_i.diagonal(Hq_i, t_i, fast=f_i)
                d = jnp.concatenate(ds)
                acc = d if acc is None else acc + d
            d_full = jnp.abs(jnp.where(ess_loc, 1.0, acc))
            return _schur_arrays_core(
                form, intg, tables[0], ess_loc, state[0], d_full, reg,
                jacobi, False,
                psum=lambda x: x,  # halo scatters complete internally
                pmax=lambda x: jax.lax.pmax(x, axis),
                globalize=lambda a: a,  # keep element-sharded
                fast=fast0,
                usplit=lambda v: v[:su],  # local primal slots
            )

        keys = ["De_inv"] + (["dshift", "safe"] if jacobi else [])
        return shard_map(
            local, mesh=self.mesh,
            in_specs=(
                tuple(self.specs), P(self.axis_name), self._state_specs(),
            ),
            out_specs={k: P(self.axis_name) for k in keys},
        )(tables, ess, state)

    # -- public jitted wrappers ----------------------------------------
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
