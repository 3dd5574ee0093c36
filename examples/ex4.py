"""Example 4: AD Obstacle Problem with PG (LVPP) — reference ex4.cpp.

Obstacle problem 0 <= u <= 0.5 via the FermiDirac mirror map on mixed
H1(p+1) x L2(p-1) spaces; outer PG loop with the alpha schedule flags of
ex4.cpp:52-72 and the lambda-increment stopping rule (ex4.cpp:203-218).

Reference smoke invocation (test.sh:9): -rule 2 -a0 0.1 -ar 2
"""

# Allow running uninstalled: `python examples/exN.py` from a source checkout.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

from mfem_ad_tpu.models import obstacle
from mfem_ad_tpu.utils.viz import maybe_export
from mfem_ad_tpu.utils import profiling


def main():
    ap = argparse.ArgumentParser(description="LVPP obstacle (reference ex4)")
    ap.add_argument("-o", "--order", type=int, default=2)
    ap.add_argument("-r", "--ref", type=int, default=3)
    ap.add_argument("-rule", "--rule", type=int, default=0,
                    help="0=CONSTANT 1=POLY 2=EXP 3=DOUBLE_EXP")
    ap.add_argument("-ma", "--max-alpha", type=float, default=1e4)
    ap.add_argument("-a0", "--alpha0", type=float, default=1.0)
    ap.add_argument("-ar", "--alpha-ratio", type=float, default=1.0)
    ap.add_argument("-ar2", "--alpha-ratio2", type=float, default=1.0)
    ap.add_argument("--solver", default="schur",
                    choices=["schur", "dense", "minres", "gmres"],
                    help="schur = exact latent elimination + Jacobi-CG "
                         "(the scalable default; 'dense' mirrors the "
                         "reference's MUMPS exactness on small problems)")
    ap.add_argument("-pv", "--paraview", action="store_true")
    ap.add_argument("--geom", default=None, choices=[None, "tet"],
                    help="tetrahedral mesh (dim=3 only; default hex)")
    ap.add_argument("-d", "--dim", type=int, default=2, choices=[2, 3],
                    help="3 = hex-mesh 3D obstacle (superset of the "
                         "2D-only reference, ex4.cpp:78)")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a jax.profiler device trace to LOGDIR "
                         "and print the per-phase cost table (SURVEY §5)")
    ap.add_argument("--dof-pg", action="store_true",
                    help="DOF-level PG variant (reference dof_pg.hpp): "
                         "entropy coupling at the H1 nodal points, L2 dual "
                         "of equal order; use modest -r (the saddle "
                         "conditioning grows like alpha x E*'' saturation)")
    ap.add_argument("--spatial-bound", action="store_true",
                    help="with --dof-pg: upper bound 0.3 + 0.2 x as a "
                         "GridFunction-backed entropy parameter "
                         "(pg.hpp:281-322 Coefficient bounds)")
    args = ap.parse_args()

    with profiling.trace(args.profile):
        if args.dof_pg:
            res, pb = obstacle.solve_dofpg(
                order=args.order,
                ref_levels=args.ref,
                dim=args.dim,
                rule_type=args.rule,
                alpha0=args.alpha0,
                max_alpha=args.max_alpha,
                ratio=args.alpha_ratio,
                ratio2=args.alpha_ratio2,
                lin_solver=("minres" if args.solver == "schur"
                            else args.solver),
                spatial_bound=args.spatial_bound,
                tol=1e-6,
                verbose=True,
            )
        else:
            res, pb = obstacle.solve(
                order=args.order,
                ref_levels=args.ref,
                dim=args.dim,
                geom=args.geom,
                rule_type=args.rule,
                alpha0=args.alpha0,
                max_alpha=args.max_alpha,
                ratio=args.alpha_ratio,
                ratio2=args.alpha_ratio2,
                lin_solver=args.solver,
                verbose=True,
            )
    u = np.asarray(res.x[: pb.primal_space.ndof])
    print(
        f"PG {'converged' if res.converged else 'stopped'} in "
        f"{res.iterations} iterations, final lambda diff {res.lambda_diff:.3e}"
    )
    ub = "0.3 + 0.2 x" if args.spatial_bound else "0.5"
    print(f"u range: [{u.min():.6f}, {u.max():.6f}] (bounds [0, {ub}])")
    if args.profile:
        profiling.print_cost_table()
    maybe_export(
        args.paraview, "ad-obstacle", pb.primal_space,
        {"x": res.x[: pb.primal_space.ndof]},
    )


if __name__ == "__main__":
    main()
