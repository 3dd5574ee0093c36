"""ex5 at ref-4 (155k dofs) to lambda < 1e-8 on CPU f64 — full recorded
trajectory (VERDICT r4 #5).

The algorithm is size-independent; this script records the full PG
trajectory on CPU f64 so the >100k-dof path is proven end-to-end on a
host with no accelerator.

Run:  nice -n 19 python tools/run_ex5_ref4_cpu.py
Writes docs/EX5_REF4_CPU_TRAJECTORY.md on completion.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mfem_ad_tpu.models import gradient_obstacle as go  # noqa: E402
from mfem_ad_tpu.norms import l1_norm  # noqa: E402
from mfem_ad_tpu.pg import PGSolver, PGStepSizeRule  # noqa: E402
from mfem_ad_tpu.solvers import NewtonOptions  # noqa: E402


def main():
    ref = int(os.environ.get("EX5_REF", "4"))
    order = 2
    t0 = time.time()
    print(f"[ex5-ref{ref}-cpu] start {time.strftime('%F %T')}", flush=True)

    # mirror gradient_obstacle.solve(lin_solver="schur", gmg=True) with a
    # trajectory-recording callback
    pb = go.build(order, ref)
    rule = PGStepSizeRule(PGStepSizeRule.EXP, 1.0, 1e6, 2.0, 1.0)
    precond = go._primal_gmg(order, ref, 10).as_preconditioner()
    nopts = NewtonOptions(
        abs_tol=1e-11, rel_tol=0.0, max_iter=20, lin_solver="schur",
        lin_tol=1e-10, lin_maxiter=2000, preconditioner=precond,
    )
    solver = PGSolver(
        pb.form, rule, latent_block=1, latent_space=pb.latent_space,
        newton_opts=nopts, max_iter=100, tol=1e-8, verbose=True,
        newton_accept=1e-5,
        checkpoint_path="/tmp/ex5_ref4_ckpt", checkpoint_every=1,
    )

    traj = []
    prev = {"lam": None}

    def record(it, x, lam):
        lam = np.asarray(lam)
        if prev["lam"] is not None:
            traj.append(float(l1_norm(
                pb.latent_space, lam - prev["lam"]
            )))
        prev["lam"] = lam

    res = solver.solve(jnp.zeros(pb.form.ndof), pb.rhs, callback=record)
    wall = time.time() - t0
    out = {
        "problem": "ex5 gradient obstacle (reference ex5.cpp)",
        "ref_levels": ref,
        "ndof": int(pb.form.ndof),
        "primal_ndof": int(pb.primal_space.ndof),
        "platform": "cpu-f64",
        "schedule": "EXP alpha0=1 ratio=2 max_alpha=1e6",
        "converged": bool(res.converged),
        "iterations": int(res.iterations),
        "final_lambda_diff": float(res.lambda_diff),
        "wall_seconds": wall,
        "newton_iters": [int(n) for n in res.newton_iters],
        "lambda_trajectory": traj,
    }
    print(json.dumps(out), flush=True)
    doc = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "docs", f"EX5_REF{ref}_CPU_TRAJECTORY.md",
    )
    with open(doc, "w") as f:
        f.write(
            f"# ex5 ref-{ref} full trajectory (CPU f64)\n\n"
            f"{out['ndof']} dofs total ({out['primal_ndof']} primal); "
            f"EXP schedule alpha0=1, ratio=2, max_alpha=1e6; "
            f"lambda tol 1e-8 (ex5.cpp:198); Newton abs-tol 1e-11, "
            f"LDU-FGMRES directions (lin_tol 1e-10) with shifted-GMG "
            f"Woodbury sigma preconditioning.\n\n"
            f"- converged: **{out['converged']}** in "
            f"{out['iterations']} PG iterations\n"
            f"- final lambda-diff: {out['final_lambda_diff']:.3e}\n"
            f"- wall: {wall/60:.1f} min on a 1-core host (f64)\n\n"
            "| PG iter | |lam - lam_prev|_L1 | inner Newton its |\n"
            "|---|---|---|\n"
            + "".join(
                f"| {i+2} | {v:.6e} | "
                f"{out['newton_iters'][i+1] if i+1 < len(out['newton_iters']) else ''} |\n"
                for i, v in enumerate(traj)
            )
        )
    print(f"[ex5-ref{ref}-cpu] wrote {doc} after {wall/60:.1f} min",
          flush=True)


if __name__ == "__main__":
    main()
