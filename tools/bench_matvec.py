"""A/B microbench: Krylov matvec (grad_mult) with full vs packed (SymHess)
Newton state — the round-4 perf lever (VERDICT r3 #1).

The matvec J v = scatter(B (Hq (B^T v))) is the true hot loop of every
LVPP/Newton solve and is HBM-bound on the Hq read; the packed triangle
cuts that read 16->10 entries/qp at n=4 (ex4/ex5) to 81->45 at n=9 (3D
elasticity).  Run on the chip:

    python tools/bench_matvec.py            # ex4 ref-3 (order 2), f64
    BM_CASE=elast3d python tools/bench_matvec.py

Prints per-case: matvec ms full / packed, speedup, plus hess_state (the
once-per-direction pack cost) for both.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _build_case(case: str):
    if case == "ex4":
        from mfem_ad_tpu.models import obstacle

        pb = obstacle.build(order=2, ref_levels=3)  # 80x80, H1p3 x L2p1
        fields = {
            "alpha": jnp.asarray(4.0),
            "latent_k0": jnp.zeros(pb.latent_space.ndof),
        }
        return pb.form, fields, 0.05
    if case == "ex5":
        from mfem_ad_tpu.models import gradient_obstacle

        pb = gradient_obstacle.build(order=2, ref_levels=3)
        fields = {
            "alpha": jnp.asarray(4.0),
            "latent_k0": jnp.zeros(pb.latent_space.ndof),
        }
        return pb.form, fields, 0.05
    if case == "elast3d":
        from mfem_ad_tpu import fespace, forms, mesh
        from mfem_ad_tpu.ad import NeoHookeanEnergy
        from mfem_ad_tpu.adeval import ADEval

        m = mesh.make_cartesian_3d(24, 24, 24)
        fes = fespace.FESpace(m, 1, vdim=3)
        f = forms.NonlinearForm(fes)
        f.add_ad_integrator(
            NeoHookeanEnergy(3, 1.0, 1.0), ADEval.GRAD | ADEval.VECTOR
        )
        return f, {}, 0.2 / 24
    raise SystemExit(f"unknown BM_CASE {case!r}")


def _timed_loop(fn, args, v0, reps0: int, reps1: int):
    """Differenced fori_loop timing of fn(*args, v)->vector, seconds/call."""

    def make(reps):
        @jax.jit
        def run(args, v):
            def body(i, acc):
                y = fn(*args, acc)
                return acc + 1e-30 * y  # serialize iterations

            return jax.lax.fori_loop(0, reps, body, v)

        return run

    r0, r1 = make(reps0), make(reps1)

    def timed(run, v):
        # fetch a scalar to sync with the device
        float(jnp.sum(run(args, v)))
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            float(jnp.sum(run(args, v)))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    v = jnp.zeros_like(v0) + 1.0
    t0v, t1v = timed(r0, v), timed(r1, v)
    return max((t1v - t0v) / (reps1 - reps0), 1e-12)


def main():
    case = os.environ.get("BM_CASE", "ex4")
    form, fields, amp = _build_case(case)
    rng = np.random.default_rng(0)
    x = jnp.asarray(amp * rng.standard_normal(form.ndof))
    tables = form._tables()
    ess = form.ess_mask

    os.environ["MFEM_AD_TPU_SYM_STATE"] = "0"
    st_full = jax.jit(form.grad_state_raw)(tables, x, fields)
    os.environ["MFEM_AD_TPU_SYM_STATE"] = "1"
    st_sym = jax.jit(form.grad_state_raw)(tables, x, fields)
    jax.block_until_ready((st_full, st_sym))

    def mv(tables, ess, state, v):
        return form.grad_mult_raw(tables, ess, state, v)

    t_full = _timed_loop(mv, (tables, ess, st_full), x, 20, 120)
    t_sym = _timed_loop(mv, (tables, ess, st_sym), x, 20, 120)

    # once-per-direction state build cost (pack relayout included)
    def gs(tables, x, flag):
        os.environ["MFEM_AD_TPU_SYM_STATE"] = flag
        f = jax.jit(lambda t, u: form.grad_state_raw(t, u, fields))
        out = f(tables, x)
        jax.block_until_ready(out)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(f(tables, x))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    s_full = gs(tables, x, "0")
    s_sym = gs(tables, x, "1")

    n = form.ndof
    print(
        f"{case}: ndof={n}  matvec full={t_full*1e3:.4f} ms  "
        f"packed={t_sym*1e3:.4f} ms  speedup={t_full/t_sym:.2f}x  |  "
        f"hess_state full={s_full*1e3:.2f} ms  packed={s_sym*1e3:.2f} ms",
        flush=True,
    )


if __name__ == "__main__":
    main()
