"""chip_smoke.py on the CPU: its plain f64 assembly reference against the
integrator's routes, its phases at tiny size, its refusal to run off a
GPU, and the compile-cache placement it reports.  The one GPU test runs
the script itself and skips where no NVIDIA GPU is present."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from mfem_ad_tpu import mesh as M  # noqa: E402
from mfem_ad_tpu.ad import (  # noqa: E402
    DiffusionEnergy,
    LinearElasticityEnergy,
    NeoHookeanEnergy,
)
from mfem_ad_tpu.adeval import ADEval  # noqa: E402
from mfem_ad_tpu.fespace import FESpace  # noqa: E402
from mfem_ad_tpu.integrator import ADBlockIntegrator  # noqa: E402
from mfem_ad_tpu.quadrature import TETRAHEDRON  # noqa: E402

VEC = ADEval.GRAD | ADEval.VECTOR


def _quad_p1_neohookean():
    m = M.make_cartesian_2d(4, 4)
    return FESpace(m, 1, vdim=2), NeoHookeanEnergy(2, 1.2, 0.8), VEC, None


def _quad_p1_distorted_neohookean():
    """Interior vertices moved: per-element Jacobians, general routes."""
    m = M.make_cartesian_2d(4, 4)
    v = m.vertices.copy()
    inner = (v > 0.0).all(axis=1) & (v < 1.0).all(axis=1)
    v[inner] += 0.06 * np.random.default_rng(3).uniform(
        -1.0, 1.0, (int(inner.sum()), 2))
    m = dataclasses.replace(m, vertices=v, structured=None)

    def general(intg):
        return not m.uniform_jacobian

    return FESpace(m, 1, vdim=2), NeoHookeanEnergy(2, 1.2, 0.8), VEC, general


def _quad_p2_diffusion():
    m = M.make_cartesian_2d(3, 3)
    energy = DiffusionEnergy(2, lambda x: 1.0 + x[0] * x[1])
    return FESpace(m, 2), energy, ADEval.GRAD, None


def _hex_p1_neohookean():
    m = M.make_cartesian_3d(3, 3, 3)

    def planar(intg):
        return "0_0" in intg.tables["W0p"]

    return FESpace(m, 1, vdim=3), NeoHookeanEnergy(3, 1.0, 1.0), VEC, planar


def _hex_p2_elasticity():
    m = M.make_cartesian_3d(2, 2, 2)
    energy = LinearElasticityEnergy(3, 1.0, 0.7)
    return FESpace(m, 2, vdim=3), energy, VEC, None


def _tet_p1_neohookean():
    m = M.make_cartesian_3d(2, 2, 2, geom=TETRAHEDRON)

    def pullback(intg):
        return intg.pullback

    return FESpace(m, 1, vdim=3), NeoHookeanEnergy(3, 1.0, 1.0), VEC, pullback


@pytest.mark.parametrize("build", [
    _quad_p1_neohookean, _quad_p2_diffusion, _hex_p1_neohookean,
    _hex_p2_elasticity, _tet_p1_neohookean, _quad_p1_distorted_neohookean,
], ids=["quad-p1-neohookean", "quad-p2-diffusion", "hex-p1-neohookean",
        "hex-p2-elasticity", "tet-p1-neohookean",
        "quad-p1-distorted-neohookean"])
def test_assembly_matches_plain_reference(build):
    """residual and element_jacobians (f64 tables) equal the plain f64
    per-element AD reference on every element, on each assembly route."""
    fes, energy, mode, route = build()
    intg = ADBlockIntegrator(energy, [fes], [mode])
    if route is not None:
        assert route(intg)
    rng = np.random.default_rng(7)
    h = 1.0 / max(fes.mesh.num_elements ** (1.0 / fes.mesh.dim), 1.0)
    u = jnp.asarray(0.1 * h * rng.standard_normal(fes.ndof))
    out = chip_smoke.check_assembly(intg, energy, fes, mode, u)
    assert out["finite"]
    assert out["res_err"] < 1e-12, out
    assert out["jac_err"] < 1e-12, out


def test_ex4_phase_tiny():
    """The ex4 phase's checks (convergence, bounds, schur vs dense early
    and converged) on the coarsest mesh; the O(h^2) bound overshoot there
    is ~7e-3."""
    out = chip_smoke.phase_ex4(ref_levels=0, check_ref_levels=0, order=1,
                               bound_tol=(1e-8, 1e-2))
    assert out["converged"] and out["ref_err"] <= chip_smoke.EX4_REF_TOL
    assert out["ref_err_converged"] <= chip_smoke.EX4_CONV_TOL
    assert out["first_iter_s"] > 0 and out["pg_iters"] > 1


def test_assembly_phase_tiny():
    """The assembly phase on its three routes, f32 tables, tiny meshes,
    with the chip's tolerances."""
    out = chip_smoke.phase_assembly(chip_smoke.assembly_cases(8, 4, 2),
                                    reps=0)
    assert set(out) == {"q1-2d", "q1-3d", "p1-tet"}
    for rec in out.values():
        assert rec["jac_err"] < 1e-4 and rec["res_err"] < 1e-5, rec


def _child_env(**extra):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_chip_smoke_refuses_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_child_env(), cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_CACHE_CHILD = (
    "import jax, jax.numpy as jnp, mfem_ad_tpu; "
    "print(jax.config.jax_compilation_cache_dir); "
    "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(3)).block_until_ready()"
)


def test_compile_cache_honours_env(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the package sets nothing and the
    cache is written there."""
    cache = str(tmp_path / "cc")
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_CHILD],
        env=_child_env(JAX_COMPILATION_CACHE_DIR=cache,
                       JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0"),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == cache
    assert os.listdir(cache)


def test_compile_cache_defaults_to_checkout():
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, mfem_ad_tpu; "
         "print(jax.config.jax_compilation_cache_dir)"],
        env=_child_env(), capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == os.path.join(
        REPO, ".jax_cache")


def _nvidia_gpu_present() -> bool:
    if shutil.which("nvidia-smi") is None:
        return False
    return subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                          timeout=60).returncode == 0


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """Runs chip_smoke.py's phases on the card, in one child process (this
    test process stays on the CPU)."""
    if not _nvidia_gpu_present():
        pytest.skip("no NVIDIA GPU on this host")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=1500,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
