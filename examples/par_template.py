"""Multi-device example skeleton — reference template/par_template.cpp.

Where the reference does Mpi::Init + ParMesh partitioning + hypre
(par_template.cpp:23-40), the JAX equivalent shards the element
axis of a built form over all visible devices with ``ShardedForm`` and
solves with the same ``newton`` driver.  Run on CPU with

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python examples/par_template.py

to emulate the reference's ``mpirun -np 8``.
"""

# Allow running uninstalled: `python examples/exN.py` from a source checkout.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import jax
import jax.numpy as jnp

from mfem_ad_tpu.models import poisson
from mfem_ad_tpu.norms import l2_error
from mfem_ad_tpu.parallel import ShardedForm
from mfem_ad_tpu.solvers import NewtonOptions, newton
from mfem_ad_tpu.utils.viz import maybe_export


def main():
    ap = argparse.ArgumentParser(
        description="multi-device skeleton (par_template.cpp)"
    )
    ap.add_argument("-o", "--order", type=int, default=2)
    ap.add_argument("-r", "--ref", type=int, default=1)
    ap.add_argument("-pv", "--paraview", action="store_true")
    args = ap.parse_args()

    devs = jax.devices()
    print(f"devices: {len(devs)} x {devs[0].platform}")

    pb = poisson.build(order=args.order, ref_levels=args.ref)
    sf = ShardedForm(pb.form)  # element axis sharded over all devices
    res = newton(
        sf,
        jnp.zeros(pb.form.ndof),
        b=pb.rhs,
        opts=NewtonOptions(
            abs_tol=1e-10, max_iter=3, lin_solver="cg", lin_tol=1e-14,
            preconditioner="jacobi",
        ),
    )
    err = l2_error(pb.space, res.x, poisson.exact_fn)
    print(f"converged={res.converged} L2 error={err:.3e}")
    maybe_export(args.paraview, "par-template", pb.space, {"u": res.x})


if __name__ == "__main__":
    main()
