"""Gather-free fast paths vs the generic edof gather/scatter.

The structured slice/pad paths (integrator._fast_gather/_fast_scatter)
must agree exactly with the generic path for every space kind, including
vector-valued L2 spaces that no solve currently exercises."""

import numpy as np
import pytest

import jax.numpy as jnp

from mfem_ad_tpu import mesh as M
from mfem_ad_tpu.ad import MassEnergy
from mfem_ad_tpu.adeval import ADEval
from mfem_ad_tpu.fespace import H1, FESpace, L2
from mfem_ad_tpu.integrator import ADBlockIntegrator


@pytest.mark.parametrize(
    "order,fe_type,vdim,dim",
    [
        (1, "h1", 1, 2),
        (2, "h1", 1, 2),
        (3, "h1", 2, 2),
        (1, "h1", 3, 3),
        (2, "h1", 1, 3),
        (0, "l2", 1, 2),
        (1, "l2", 2, 2),
        (1, "l2", 3, 3),
        # structured TRIANGLE meshes: grouped 2-orientation slice paths
        (1, "h1", 1, "tri"),
        (2, "h1", 1, "tri"),
        (2, "h1", 2, "tri"),
        (3, "h1", 1, "tri"),
    ],
)
def test_fast_gather_scatter_matches_generic(order, fe_type, vdim, dim):
    from mfem_ad_tpu.quadrature import TRIANGLE

    m = (
        M.make_cartesian_2d(3, 2, TRIANGLE)
        if dim == "tri"
        else M.make_cartesian_2d(3, 2)
        if dim == 2
        else M.make_cartesian_3d(2, 3, 2)
    )
    sp = FESpace(m, max(order, 1) if fe_type == "h1" else order,
                 L2 if fe_type == "l2" else H1, vdim=vdim)
    intg = ADBlockIntegrator(
        MassEnergy(vdim), [sp], [ADEval.VALUE | (ADEval.VECTOR if vdim > 1
                                                 else ADEval(0))]
    )
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(sp.ndof))
    g_fast = np.asarray(intg.gather(0, u, fast=True))
    g_gen = np.asarray(intg.gather(0, u, fast=False))
    assert np.array_equal(g_fast, g_gen)

    re = jnp.asarray(rng.standard_normal(g_fast.shape))
    s_fast = np.asarray(intg.scatter(0, re, fast=True))
    s_gen = np.asarray(intg.scatter(0, re, fast=False))
    assert np.allclose(s_fast, s_gen, atol=1e-14)

    # adjointness: <gather(u), re> == <u, scatter(re)>
    lhs = float(jnp.sum(jnp.asarray(g_fast) * re))
    rhs = float(jnp.dot(u, jnp.asarray(s_fast)))
    assert np.isclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("dim,vdim", [(2, 2), (3, 3), (2, 1)])
def test_blocked_factors_match_einsum_route(dim, vdim):
    """R0/W0/D0 blocked-GEMM contractions == the direct B-einsum route.

    The blocked factors exploit the vdim block-diagonal structure of the
    stacked shape matrix (vdim_s*vdim_t fewer FLOPs); they must reproduce
    the reference contraction (ad_intg.hpp:260-334) exactly."""
    from mfem_ad_tpu.ad import NeoHookeanEnergy

    m = M.make_cartesian_2d(3, 2) if dim == 2 else M.make_cartesian_3d(
        2, 2, 2
    )
    sp = FESpace(m, 2, H1, vdim=vdim)
    mode = ADEval.GRAD | (ADEval.VECTOR if vdim > 1 else ADEval(0))
    energy = (
        NeoHookeanEnergy(dim, 1.0, 1.0) if vdim > 1 else MassEnergy(dim)
    )
    if vdim == 1:
        from mfem_ad_tpu.ad import DiffusionEnergy

        energy = DiffusionEnergy(dim)
    intg = ADBlockIntegrator(energy, [sp], [mode])
    t = intg.tables
    # routing is shape-dependent (padded-tile cost model); whatever factor
    # set was installed must reproduce the plain einsum route exactly
    assert "R" in t and "D0" in t

    rng = np.random.default_rng(3)
    u = jnp.asarray(0.02 * rng.standard_normal(sp.ndof))

    # strip the blocked + full factors to force the einsum route
    t_plain = {k: v for k, v in t.items()
               if k not in ("R", "R0", "W", "W0", "D0")}

    r_blk = [np.asarray(r) for r in intg.residual([u], tables=t)]
    r_ein = [np.asarray(r) for r in intg.residual([u], tables=t_plain)]
    for a, b in zip(r_blk, r_ein):
        assert np.allclose(a, b, atol=1e-12)

    Hq = intg.hess_state([u], tables=t)
    A_blk = np.asarray(intg.element_matrices(Hq, 0, 0, tables=t))
    A_ein = np.asarray(intg.element_matrices(Hq, 0, 0, tables=t_plain))
    assert np.allclose(A_blk, A_ein, atol=1e-11)

    d_blk = [np.asarray(d) for d in intg.diagonal(Hq, tables=t)]
    d_ein = [np.asarray(d) for d in intg.diagonal(Hq, tables=t_plain)]
    for a, b in zip(d_blk, d_ein):
        assert np.allclose(a, b, atol=1e-12)

    x_blk = np.asarray(intg.x_qp([u], tables=t))
    x_ein = np.asarray(intg.x_qp([u], tables=t_plain))
    assert np.allclose(x_blk, x_ein, atol=1e-13)


def test_blocked_factor_routing_cost_model():
    """The padded-tile cost model must keep the full-W GEMM at the
    headline Q1/2D/vdim=2 config (even against the mirrored vdim-triangle
    M = 3) and switch to the blocked W0 factor where K/N fill 128-wide
    tiles (p2+/vector or 3D), where the diagonal pair contracts only the
    upper vdim-block triangle."""
    from mfem_ad_tpu.ad import NeoHookeanEnergy

    # headline config: tiny K/N -> full W, no W0, no R0
    m2 = M.make_cartesian_2d(3, 2)
    i_head = ADBlockIntegrator(
        NeoHookeanEnergy(2, 1.0, 1.0), [FESpace(m2, 1, H1, vdim=2)],
        [ADEval.GRAD | ADEval.VECTOR],
    )
    assert "0_0" in i_head.tables["W"]
    assert "0_0" not in i_head.tables["W0"]
    assert "R0" not in i_head.tables

    # p2/3D vector: full W exceeds its cap; blocked W0 must exist (and
    # element_matrices mirrors the upper vdim-block triangle)
    m3 = M.make_cartesian_3d(2, 2, 2)
    i_3d = ADBlockIntegrator(
        NeoHookeanEnergy(3, 1.0, 1.0), [FESpace(m3, 2, H1, vdim=3)],
        [ADEval.GRAD | ADEval.VECTOR],
    )
    assert "0_0" not in i_3d.tables["W"]
    assert "0_0" in i_3d.tables["W0"]


def test_padded_tables_keep_planar_and_unstructured_routes():
    """padded_tables must carry the W0p (planar 3D assembly) and einv
    (unstructured transpose-gather scatter) tables through the copy-pad
    (VERDICT r4 #4: both were silently dropped, demoting non-divisible
    ShardedForms to slower routes)."""
    from mfem_ad_tpu import mesh as M2
    from mfem_ad_tpu.ad import NeoHookeanEnergy

    # 3D p1 hex, 27 elements (non-divisible by 8): planar factor W0p
    m3 = M2.make_cartesian_3d(3, 3, 3)
    i3 = ADBlockIntegrator(
        NeoHookeanEnergy(3, 1.0, 1.0), [FESpace(m3, 1, H1, vdim=3)],
        [ADEval.GRAD | ADEval.VECTOR],
    )
    assert "0_0" in i3.tables.get("W0p", {})
    pt = i3.padded_tables(8)
    assert pt is not i3.tables  # actually padded
    assert "0_0" in pt.get("W0p", {}), "W0p dropped by padded_tables"

    # unstructured triangle mesh (sloped_rectangle, 12 elements after one
    # refine -> non-divisible by 8): einv transpose-gather map
    m2 = M2.read_mfem_mesh(
        "/root/reference/data/sloped_rectangle.mesh"
    ).uniform_refine(1)
    sp = FESpace(m2, 2, H1)
    i2 = ADBlockIntegrator(MassEnergy(1), [sp], [ADEval.VALUE])
    assert 0 in i2.tables.get("einv", {})
    assert sp.num_elements % 8 != 0
    pt2 = i2.padded_tables(8)
    assert 0 in pt2.get("einv", {}), "einv dropped by padded_tables"


def test_sharded_unstructured_nondivisible_matches_serial():
    """A non-divisible unstructured ShardedForm must produce identical
    residual/matvec/diagonal to its serial form — through the einv
    transpose-gather scatter, not the serialized scatter-add."""
    import jax

    from mfem_ad_tpu import mesh as M2
    from mfem_ad_tpu.ad import DiffusionEnergy
    from mfem_ad_tpu.forms import NonlinearForm
    from mfem_ad_tpu.parallel import ShardedForm

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    m = M2.read_mfem_mesh(
        "/root/reference/data/sloped_rectangle.mesh"
    ).uniform_refine(1)
    fes = FESpace(m, 2, H1)
    assert fes.num_elements % 8 != 0
    nlf = NonlinearForm(fes)
    nlf.add_ad_integrator(DiffusionEnergy(m.dim), ADEval.GRAD)
    nlf.set_essential_bc([np.ones(m.max_bdr_attribute())])
    sf = ShardedForm(nlf)
    assert 0 in sf.tables[0].get("einv", {})  # route survives sharding
    rng = np.random.default_rng(11)
    u = jnp.asarray(rng.standard_normal(fes.ndof))
    assert np.allclose(
        np.asarray(nlf.mult(u)), np.asarray(sf.mult(u)), atol=1e-12
    )
    st_s = nlf.grad_state(u)
    st_p = sf.grad_state(u)
    v = jnp.asarray(rng.standard_normal(fes.ndof))
    assert np.allclose(
        np.asarray(nlf.grad_mult(st_s, v)),
        np.asarray(sf.grad_mult(st_p, v)), atol=1e-12,
    )
    assert np.allclose(
        np.asarray(nlf.grad_diag(st_s)),
        np.asarray(sf.grad_diag(st_p)), atol=1e-12,
    )
