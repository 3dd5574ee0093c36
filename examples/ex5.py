"""Example 5: gradient-constrained obstacle via LVPP — reference ex5.cpp.

||grad u|| <= 0.1 + 0.2x + 0.4y via the Hellinger mirror map on
H1(p) x H1(p-1)^dim triangle-mesh spaces; lambda tolerance 1e-8
(ex5.cpp:198)."""

# Allow running uninstalled: `python examples/exN.py` from a source checkout.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

from mfem_ad_tpu.models import gradient_obstacle
from mfem_ad_tpu.utils.viz import maybe_export
from mfem_ad_tpu.utils import profiling


def main():
    ap = argparse.ArgumentParser(
        description="LVPP gradient obstacle (reference ex5)"
    )
    ap.add_argument("-o", "--order", type=int, default=2)
    ap.add_argument("-r", "--ref", type=int, default=3)
    ap.add_argument("-rule", "--rule", type=int, default=0)
    ap.add_argument("-ma", "--max-alpha", type=float, default=1e6)
    ap.add_argument("-a0", "--alpha0", type=float, default=1.0)
    ap.add_argument("-ar", "--alpha-ratio", type=float, default=1.0)
    ap.add_argument("-ar2", "--alpha-ratio2", type=float, default=1.0)
    ap.add_argument("--solver", default="schur",
                    choices=["schur", "dense", "minres", "gmres"],
                    help="schur = lumped-latent block preconditioner + "
                         "MINRES on the saddle system (scalable "
                         "default for the H1^dim latent)")
    ap.add_argument("-pv", "--paraview", action="store_true")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a jax.profiler device trace to LOGDIR "
                         "and print the per-phase cost table (SURVEY §5)")
    args = ap.parse_args()

    with profiling.trace(args.profile):
        res, pb = gradient_obstacle.solve(
            order=args.order,
            ref_levels=args.ref,
            rule_type=args.rule,
            alpha0=args.alpha0,
            max_alpha=args.max_alpha,
            ratio=args.alpha_ratio,
            ratio2=args.alpha_ratio2,
            lin_solver=args.solver,
            verbose=True,
        )
    print(
        f"PG {'converged' if res.converged else 'stopped'} in "
        f"{res.iterations} iterations, final lambda diff {res.lambda_diff:.3e}"
    )
    if args.profile:
        profiling.print_cost_table()
    maybe_export(
        args.paraview, "ad-grad-obstacle", pb.primal_space,
        {"x": res.x[: pb.primal_space.ndof]},
    )


if __name__ == "__main__":
    main()
