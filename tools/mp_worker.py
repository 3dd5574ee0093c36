"""Multi-process SPMD worker: one rank of a process-spanning device mesh.

The JAX analogue of one MPI rank of the reference's distributed-memory
run (Mpi::Init, ex4.cpp:33-37): ``jax.distributed.initialize`` builds the
coordination service, every process sees the GLOBAL device list, and the
same single program runs on each process (multi-controller SPMD).  The
element-sharded assembly + psum of ``parallel.ShardedForm`` then spans
processes exactly as it spans devices.

Usage (spawned by tests/test_multiprocess.py, one per process):
    python tools/mp_worker.py <process_id> <num_processes> <coordinator>

Prints ``MP_OK <residual-norm>`` on success; exits nonzero on mismatch.
"""

import os
import sys


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    coordinator = sys.argv[3]

    import jax

    # the multi-process test runs on the CPU backend
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=nproc, process_id=pid
    )
    n_local = len(jax.local_devices())
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == nproc * n_local

    import numpy as np
    import jax.numpy as jnp

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    from mfem_ad_tpu.models import obstacle
    from mfem_ad_tpu.parallel import ShardedForm

    pb = obstacle.build(order=1, ref_levels=0, n0=8)  # 64 elements
    sf = ShardedForm(pb.form, devices=jax.devices())

    rng = np.random.default_rng(0)  # same seed on every process
    u = 0.1 * rng.standard_normal(pb.form.ndof)
    latent_k = 0.1 * rng.standard_normal(pb.latent_space.ndof)
    fields = {
        "alpha": sf.replicate(np.asarray(1.0)),
        "latent_k0": sf.replicate(latent_k),
    }

    # serial oracle (process-local, plain single-device form)
    r_serial = np.asarray(pb.form.mult(jnp.asarray(u), {
        "alpha": jnp.asarray(1.0), "latent_k0": jnp.asarray(latent_k),
    }))

    r = sf.mult(sf.replicate(u), fields)
    r_np = np.asarray(r)  # fully replicated: addressable everywhere
    if not np.allclose(r_np, r_serial, atol=1e-12):
        print("MP_MISMATCH", np.abs(r_np - r_serial).max(), flush=True)
        sys.exit(1)

    state = sf.grad_state(sf.replicate(u), fields)
    v = sf.replicate(rng.standard_normal(pb.form.ndof))
    y = np.asarray(sf.grad_mult(state, v))

    # Full distributed LVPP solve: the reference's mpirun smoke runs ex4
    # to convergence (test.sh:9); here the PG loop with the production
    # Schur solver spans the two-process mesh and the end state must
    # match a process-local serial solve to solver tolerance.
    from mfem_ad_tpu.pg import PGSolver, PGStepSizeRule
    from mfem_ad_tpu.solvers import NewtonOptions

    rule = PGStepSizeRule(PGStepSizeRule.EXP, 0.1, 1e4, 2.0)
    nopts = NewtonOptions(
        abs_tol=1e-9, max_iter=20, lin_solver="schur", lin_tol=1e-12,
        lin_maxiter=2000,
    )

    def run(form):
        solver = PGSolver(
            form, rule, latent_block=1, latent_space=pb.latent_space,
            newton_opts=nopts, max_iter=40, tol=1e-8,
        )
        return solver.solve(jnp.zeros(pb.form.ndof), pb.rhs)

    res_mp = run(sf)
    res_serial = run(pb.form)
    assert res_mp.converged and res_serial.converged, (
        res_mp.converged, res_serial.converged)
    x_mp = np.asarray(res_mp.x)
    x_serial = np.asarray(res_serial.x)
    du = np.abs(x_mp - x_serial).max()
    if du > 1e-7:
        print("MP_SOLVE_MISMATCH", du, flush=True)
        sys.exit(1)
    u_mp = x_mp[: pb.primal_space.ndof]
    print(
        f"MP_OK {np.linalg.norm(r_np):.12e} {np.linalg.norm(y):.12e} "
        f"pg_its={res_mp.iterations} lam={res_mp.lambda_diff:.6e} "
        f"u=[{u_mp.min():.8f},{u_mp.max():.8f}]",
        flush=True,
    )


if __name__ == "__main__":
    main()
