#!/usr/bin/env python3
"""Smoke run of the main path on an NVIDIA GPU, through the user's entry
points, in one process.

Phases (all but ``four`` run by default):

ex4       The flagship LVPP obstacle solve at the reference's documented
          smoke setting (``examples/ex4.py -rule 2 -a0 0.1 -ar 2``,
          reference test.sh:9): order 2, ref 3, 83,681 dofs, f64, Schur
          elimination + GMG.  Checks convergence and the bounds
          0 <= u <= 0.5, and checks the Schur path against the dense-direct
          Newton (the stand-in for the reference's MUMPS) at ref 1.
assembly  Residuals and dense element Jacobians at the benchmark's widths
          (bench._build / bench._build_tet, neo-Hookean, f32): Q1 2D vdim 2
          on 512^2 quads, Q1 3D vdim 3 on 64^3 hexes (planar route), p1 Kuhn
          tets on 32^3*6 elements (pullback route).  Each is compared with
          ``plain_reference`` (f64, Precision.HIGHEST) on 4,096 elements
          for the Jacobians and on every element for the residual.  The
          2D and 3D Jacobian passes are traced and split into device
          kernel times.
four      (``--four``; runs alone) One production Schur Newton step of ex4
          at order 2, ref 3 on ``HaloShardedForm`` over four GPUs, against
          the same step of the serial form on one GPU.

It refuses to run anywhere but on a GPU.  It prints the card's name and
power limit (nvidia-smi) first, and, only when every phase passed, one
JSON line last:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Run: ``python chip_smoke.py`` (one GPU) or ``python chip_smoke.py --four``
(four GPUs).  ``--trace-dir DIR`` keeps the assembly traces.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

SUBSET = 4096  # elements whose Jacobians are compared with the reference
JAC_TOL = 5e-3  # HIGH-precision (TF32) assembly GEMM vs f64, rel. max|A|
RES_TOL = 1e-5  # residual path runs at the package default, "highest"
EX4_BOUND_TOL = (1e-8, 1e-3)  # u in [-1e-8, 0.5 + 1e-3]
EX4_REF_TOL = 1e-6  # schur vs dense u at ref 1 after EX4_REF_PG_ITERS
EX4_REF_PG_ITERS = 8  # PG iterations, before the latent regularization bites
EX4_CONV_TOL = 1e-3  # schur vs dense converged u at ref 1 (see phase_ex4)
FOUR_TOL = 1e-9  # halo vs serial Newton step, relative max norm
EX4 = dict(order=2, rule_type=2, alpha0=0.1, ratio=2.0, max_alpha=1e4)


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(n: int = 1):
    """The devices, or exit nonzero: this script never runs on the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}")
    if len(devs) < n:
        sys.exit(f"chip_smoke: needs {n} GPUs, JAX found {len(devs)}")
    return devs


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def check(ok: bool, msg: str) -> None:
    """A smoke check that holds under ``python -O`` too."""
    if not ok:
        raise RuntimeError(msg)


class CacheEvents:
    """Counts persistent-compile-cache hits and misses as JAX reports them,
    while the ``with`` block runs."""

    def __enter__(self):
        import jax

        self.hits = self.misses = 0
        jax.monitoring.register_event_listener(self._on)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_listener(self._on)

    def _on(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1


def peak_bytes(device=None) -> int | None:
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# plain reference
# ---------------------------------------------------------------------------


def plain_reference(energy, fes, mode, u, elems, ir_order=None):
    """Plain f64 reference of E(u) = sum_e sum_q w_q f(B_q u_e).

    Shares with the integrator only the reference-element basis, the
    quadrature rule, the mesh and the energy's point function.  Per
    element, from its corner coordinates: the isoparametric Jacobian
    J = sum_c X_c dN_c, det J and J^-1 by ``jnp.linalg``, the physical
    shape gradients and weights; then the element energy as a plain sum
    over quadrature points, ``jax.grad`` for the element residual and
    ``jax.hessian`` for the element Jacobian, each vmapped over elements,
    at Precision.HIGHEST.  ``mode`` must be GRAD (optionally VECTOR).

    Returns ``(r, A)``: the residual assembled over EVERY element
    [ndof], and the dense element Jacobians of ``elems`` [len(elems),
    nde, nde] in the byNODES flat layout (v*nd + d).
    """
    import jax
    import jax.numpy as jnp

    from mfem_ad_tpu.adeval import ADEval
    from mfem_ad_tpu.basis import ref_element
    from mfem_ad_tpu.coefficients import QPContext
    from mfem_ad_tpu.quadrature import default_ad_order, get_rule

    if mode & ~(ADEval.GRAD | ADEval.VECTOR):
        raise ValueError(f"plain_reference: GRAD inputs only, got {mode!r}")
    mesh = fes.mesh
    ir = get_rule(mesh.geom, ir_order or default_ad_order(fes.order))
    geo = ref_element(mesh.geom, 1)
    N = np.asarray(geo.eval(ir.points), np.float64)  # [nq, nc]
    dN = np.asarray(geo.grad(ir.points), np.float64)  # [nq, nc, dim]
    dphi = np.asarray(ref_element(mesh.geom, fes.order).grad(ir.points),
                      np.float64)  # [nq, nd, dim]
    wq = np.asarray(ir.weights, np.float64)
    X = np.asarray(mesh.corner_coords(), np.float64)  # [ne, nc, dim]
    ne, nq = X.shape[0], wq.shape[0]
    ctx = QPContext(np.einsum("qc,eck->eqk", N, X), ir=ir, mesh=mesh)
    p = {k: np.broadcast_to(np.asarray(c.eval_qp(ctx), np.float64),
                            (ne, nq, c.size))
         for k, c in energy.params.items()}
    vdim, nd = fes.vdim, fes.nd
    idx = (np.asarray(fes.edof)[:, None, :]
           + np.arange(vdim)[None, :, None] * fes.ndof_scalar
           ).reshape(ne, vdim * nd)

    def e_energy(ue, Xe, pe):
        J = jnp.einsum("qcm,ck->qkm", dN, Xe)  # dx_k / dxi_m
        G = jnp.einsum("qdm,qmk->qdk", dphi, jnp.linalg.inv(J))
        x = jnp.einsum("qdk,vd->qvk", G, ue.reshape(vdim, nd))
        f = jax.vmap(energy.energy)(x.reshape(nq, -1), pe)
        return jnp.sum(wq * jnp.linalg.det(J) * f)

    u64 = np.asarray(u, np.float64)
    with jax.default_matmul_precision("highest"):
        re = jax.jit(jax.vmap(jax.grad(e_energy)))(u64[idx], X, p)
        r = jnp.zeros(fes.ndof).at[idx.reshape(-1)].add(re.reshape(-1))
        sub = np.asarray(elems)
        A = jax.jit(jax.vmap(jax.hessian(e_energy)))(
            u64[idx[sub]], X[sub], {k: v[sub] for k, v in p.items()})
    return np.asarray(r), np.asarray(A)


def rel_max_err(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300))


def subset(ne: int, n: int = SUBSET) -> np.ndarray:
    """n element indices spread evenly over the mesh (all if ne <= n)."""
    return np.unique(np.linspace(0, ne - 1, min(n, ne)).astype(np.int64))


def check_assembly(intg, energy, fes, mode, u, elems=None, reps: int = 0):
    """Compare intg.residual / intg.element_jacobians with the plain
    reference.  Returns the errors, and per-pass rates when ``reps`` > 0
    (device-synchronized host clock; information only)."""
    import jax

    tables = intg.tables
    res_fn = jax.jit(lambda t, u: intg.residual([u], tables=t)[0])
    jac_fn = jax.jit(lambda t, u: intg.element_jacobians([u], tables=t))
    r = np.asarray(res_fn(tables, u))
    A = jac_fn(tables, u)
    ne = A.shape[0]
    elems = subset(ne) if elems is None else elems
    A_sub = np.asarray(A[elems])
    del A
    r_ref, A_ref = plain_reference(energy, fes, mode, u, elems)
    out = {"res_err": rel_max_err(r, r_ref),
           "jac_err": rel_max_err(A_sub, A_ref),
           "ne": ne, "finite": bool(np.isfinite(r).all()
                                    and np.isfinite(A_sub).all())}
    for name, fn in (("res", res_fn), ("jac", jac_fn)):
        if reps:
            jax.block_until_ready(fn(tables, u))
            t0 = time.perf_counter()
            for _ in range(reps):
                y = fn(tables, u)
            jax.block_until_ready(y)
            out[f"{name}_rate"] = ne * reps / (time.perf_counter() - t0)
    out["jac_fn"] = jac_fn
    return out


# ---------------------------------------------------------------------------
# device trace reduction
# ---------------------------------------------------------------------------

_GEMM = re.compile(r"gemm|xmma|cutlass|cublas|matmul", re.I)


def kernel_times(logdir: str) -> dict:
    """{kernel name: total device ns} over the GPU planes of the newest
    trace under ``logdir`` (stream lines only: one event per kernel)."""
    import jax

    paths = glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    out: dict = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.lower().startswith("stream"):
                continue
            for ev in line.events:
                out[ev.name] = out.get(ev.name, 0.0) + ev.duration_ns
    return out


def trace_program(fn, args, calls: int, logdir: str) -> dict:
    """{kernel name: device ns per call} over ``calls`` traced calls of
    ``fn(*args)`` (after one untraced warm-up call)."""
    import jax

    from mfem_ad_tpu.utils import profiling

    jax.block_until_ready(fn(*args))
    with profiling.trace(logdir):
        for _ in range(calls):
            y = fn(*args)
        jax.block_until_ready(y)
    return {k: t / calls for k, t in kernel_times(logdir).items()}


def trace_jacobian_pass(intg, jac_fn, u, ne: int, calls: int,
                        logdir: str) -> dict:
    """Device time per Jacobian pass, split into GEMM and other kernels,
    and the share of the pass that producing H does not explain.

    The second traced program is the same Hessian producer with Hq
    summed in place (``sum(hess_state)``): no Hq write, no relayout, no
    contraction.  ``pass - producer_reduced`` is then the device time the
    pass spends writing, relaying out and reading Hq plus the contraction
    itself: an upper bound on the time moving Hq takes, and on what a
    fused producer + contraction kernel could save.  The lower bound is
    Hq written once and read once at the data-sheet HBM rate."""
    import jax
    import jax.numpy as jnp

    import bench

    args = (intg.tables, u)
    times = trace_program(jac_fn, args, calls, os.path.join(logdir, "jac"))
    prod_fn = jax.jit(lambda t, u: jnp.sum(intg.hess_state([u], tables=t)))
    prod = sum(trace_program(prod_fn, args, calls,
                             os.path.join(logdir, "producer")).values())
    total = sum(times.values())
    gemm = sum(t for k, t in times.items() if _GEMM.search(k))
    n = intg.n_input
    hq = ne * intg.nq * n * n * 4  # f32 Hq, bytes
    floor_ns = 2 * hq / bench.device_peaks()["hbm_bytes"] * 1e9
    top = sorted(times.items(), key=lambda kv: -kv[1])[:6]
    return {"pass_ns": total, "gemm_ns": gemm, "other_ns": total - gemm,
            "top": [(k[:80], t) for k, t in top],
            "producer_reduced_ns": prod, "hq_bytes": hq,
            "hq_floor_ns": floor_ns,
            "hq_share_min": floor_ns / total,
            "hq_share_max": (total - prod) / total}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_ex4(ref_levels: int = 3, check_ref_levels: int = 1,
              order: int = 2, n0: int = 10,
              check_pg_iters: int = EX4_REF_PG_ITERS,
              bound_tol=EX4_BOUND_TOL) -> dict:
    """The ex4 solve with its checks.  Raises RuntimeError on failure.

    ``bound_tol`` = (below 0, above 0.5): the bound holds weakly, and the
    pointwise overshoot is the O(h^2) interpolation error of the
    saturated mirror map on the contact set, so coarse meshes need more.

    The dense-direct comparison at ``check_ref_levels``: the Schur solve
    runs to its stopping rule, then the dense-direct Newton runs as many
    PG iterations on the same alpha schedule (tol=0).  Their u agree to
    ``EX4_REF_TOL`` after ``check_pg_iters`` iterations, and the converged
    states to ``EX4_CONV_TOL``: the Schur path eliminates a latent block
    regularized by 1e-6 max|D_e|, and once E*'' underflows on the contact
    set that bias survives its one refinement pass.  Both end states pass
    Newton's absolute test, whose latent rows carry a 1/alpha factor
    (6.9e-4 at ref 1 on the CPU in f64; 6.1e-6 with 1e-8 and two
    refinement passes).  Raises RuntimeError on failure."""
    import jax

    from mfem_ad_tpu.models import obstacle

    kw = dict(EX4, order=order, n0=n0)
    marks = []
    first = {}

    with CacheEvents() as cache:
        def on_iter(it, x, lam):
            jax.block_until_ready(x)
            marks.append(time.perf_counter())
            if it == 0:
                first.update(hits=cache.hits, misses=cache.misses)

        t0 = time.perf_counter()
        res, pb = obstacle.solve(ref_levels=ref_levels, callback=on_iter,
                                 **kw)
    nu = pb.primal_space.ndof
    u = np.asarray(res.x[:nu])
    steady = ((marks[-1] - marks[0]) / (len(marks) - 1)
              if len(marks) > 1 else float("nan"))
    out = {
        "ndof": pb.form.ndof, "converged": res.converged,
        "pg_iters": res.iterations, "newton_iters": sum(res.newton_iters),
        "first_iter_s": marks[0] - t0 if marks else float("nan"),
        "steady_iter_s": steady, "u_min": float(u.min()),
        "u_max": float(u.max()), "peak_bytes": peak_bytes(),
        "cache_first_iter": first,
    }
    lo, hi = bound_tol
    check(res.converged, f"ex4 PG did not converge: {out}")
    check(u.min() >= -lo and u.max() <= 0.5 + hi, f"ex4 bounds: {out}")
    us, ud = {}, {}
    rs, pbc = obstacle.solve(
        lin_solver="schur", ref_levels=check_ref_levels,
        callback=lambda it, x, lam: us.__setitem__(it, np.asarray(x)), **kw)
    check(rs.converged, f"ex4 ref {check_ref_levels} schur: not converged")
    obstacle.solve(
        lin_solver="dense", ref_levels=check_ref_levels,
        max_pg_iter=rs.iterations, tol=0.0,
        callback=lambda it, x, lam: ud.__setitem__(it, np.asarray(x)), **kw)
    nc = pbc.primal_space.ndof
    k, last = min(check_pg_iters, rs.iterations) - 1, rs.iterations - 1
    out["ref_pg_iters"] = rs.iterations
    out["ref_err"] = float(np.abs(us[k][:nc] - ud[k][:nc]).max())
    out["ref_err_converged"] = float(
        np.abs(us[last][:nc] - ud[last][:nc]).max())
    check(out["ref_err"] <= EX4_REF_TOL, f"ex4 schur vs dense: {out}")
    check(out["ref_err_converged"] <= EX4_CONV_TOL,
          f"ex4 converged schur vs dense: {out}")
    return out


def assembly_cases(n2: int = 512, n3: int = 64, nt: int = 32):
    """(label, build function, route check) of the assembly phase."""
    import bench

    def planar(intg):
        return "0_0" in intg.tables["W0p"] and intg.nq <= 32

    return (
        ("q1-2d", lambda: bench._build(1, 2, n2), lambda intg: True),
        ("q1-3d", lambda: bench._build(1, 3, n3), planar),
        ("p1-tet", lambda: bench._build_tet(1, nt),
         lambda intg: intg.pullback),
    )


def phase_assembly(cases=None, reps: int = 5, trace_dir: str | None = None,
                   traced=("q1-2d", "q1-3d")) -> dict:
    """Residuals and element Jacobians against the plain reference."""
    from mfem_ad_tpu.ad import NeoHookeanEnergy
    from mfem_ad_tpu.adeval import ADEval

    results = {}
    for label, build, route_ok in cases or assembly_cases():
        m, fes, intg, u = build()
        check(route_ok(intg), f"{label}: not on its assembly route")
        energy = NeoHookeanEnergy(m.dim, 1.0, 1.0)
        out = check_assembly(intg, energy, fes,
                             ADEval.GRAD | ADEval.VECTOR, u, reps=reps)
        jac_fn = out.pop("jac_fn")
        if trace_dir is not None and label in traced:
            out["trace"] = trace_jacobian_pass(
                intg, jac_fn, u, out["ne"], 3, os.path.join(trace_dir, label))
        results[label] = out
        log(f"assembly {label}: {json.dumps(out, default=str)}")
        check(out["finite"], f"{label}: non-finite output")
        check(out["jac_err"] <= JAC_TOL, f"{label}: jacobian {out}")
        check(out["res_err"] <= RES_TOL, f"{label}: residual {out}")
    return results


def phase_four(order: int = 2, ref_levels: int = 3, n0: int = 10,
               n_dev: int = 4) -> dict:
    """One halo-sharded Schur Newton step against the serial step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as entry
    from mfem_ad_tpu.models import obstacle
    from mfem_ad_tpu.parallel import HaloShardedForm

    devs = require_gpu(n_dev)[:n_dev]
    pb = obstacle.build(order=order, ref_levels=ref_levels, n0=n0)
    alpha = jnp.asarray(EX4["alpha0"])
    lk = jnp.zeros(pb.latent_space.ndof)
    x0 = np.zeros(pb.form.ndof)

    def compiled_step(form, args):
        """(compiled step, its output, steady wall of one more call)."""
        step = jax.jit(entry._newton_step_fn(form, schur=True))
        exe = step.lower(*args).compile()
        jax.block_until_ready(exe(*args))
        t0 = time.perf_counter()
        y = jax.block_until_ready(exe(*args))
        return exe, y, time.perf_counter() - t0

    _, x_s, t_s = compiled_step(pb.form, (
        pb.form._tables(), pb.form.ess_mask, jnp.asarray(x0), pb.rhs,
        alpha, lk))
    sf = HaloShardedForm(pb.form, devices=devs)
    rep = NamedSharding(sf.mesh, P())
    halo, x_h, t_h = compiled_step(sf, (
        sf._tables(), sf.ess_mask, sf.dist_array(x0),
        sf.dist_array(np.asarray(pb.rhs)), jax.device_put(alpha, rep),
        jax.device_put(lk, rep)))
    hlo = halo.as_text()
    coll = re.findall(
        r"= [^=]*? (all-reduce|collective-permute|all-gather|reduce-scatter"
        r"|all-to-all)(?:-start)?\(", hlo)
    xs = np.asarray(x_s)
    out = {
        "ndof": pb.form.ndof, "devices": n_dev, "serial_step_s": t_s,
        "halo_step_s": t_h,
        "rel_err": rel_max_err(sf.from_dist(np.asarray(x_h)), xs),
        "collectives": {k: coll.count(k) for k in sorted(set(coll))},
        "finite": bool(np.isfinite(xs).all()),
    }
    check(out["finite"], f"four: non-finite step {out}")
    check(out["rel_err"] <= FOUR_TOL, f"four: halo vs serial {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU halo phase")
    ap.add_argument("--trace-dir", default=None,
                    help="keep the assembly traces here")
    args = ap.parse_args(argv)
    n_dev = 4 if args.four else 1
    devs = require_gpu(n_dev)[:n_dev]  # the devices the phases use
    log(f"gpu: {gpu_name_and_power()}")

    import jax

    import mfem_ad_tpu

    log(f"jax {jax.__version__}; devices: {len(devs)} x "
        f"{devs[0].device_kind}; compile cache: "
        f"{jax.config.jax_compilation_cache_dir} "
        f"(checkout {mfem_ad_tpu.CHECKOUT})")
    if args.four:
        t0 = time.perf_counter()
        out = phase_four()
        log(f"phase four ({time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(out)}")
    else:
        t0 = time.perf_counter()
        out = phase_ex4()
        log(f"phase ex4 ({time.perf_counter() - t0:.1f} s): "
            f"{json.dumps(out)}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            phase_assembly(trace_dir=args.trace_dir or tmp)
        log(f"phase assembly ({time.perf_counter() - t0:.1f} s): ok")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
