"""True multi-process distributed run — the analogue of the reference's
distributed-memory MPI semantics (Mpi::Init ex4.cpp:33-37, hypre
collectives): two OS processes, each owning 4 virtual CPU devices, joined
by ``jax.distributed`` into one 8-device mesh; ``ShardedForm`` assembly
spans the process boundary (the multi-host path of a cluster)."""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_assembly():
    port = _free_port()
    nproc = 2
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)  # worker forces cpu via jax.config
    worker = os.path.join(_REPO, "tools", "mp_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(nproc),
             f"127.0.0.1:{port}"],
            env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process worker timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
        assert "MP_OK" in out
    # both processes computed identical (replicated) global results
    lines = [
        next(ln for ln in out.splitlines() if ln.startswith("MP_OK"))
        for _, out, _ in outs
    ]
    assert lines[0] == lines[1], lines
