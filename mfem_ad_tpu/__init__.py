"""mfem_ad_tpu — a JAX automatic-differentiation finite-element framework
for accelerators.

Re-designed from scratch with the capabilities of the reference library
``dohyun-cse/mfem-ad`` (a C++17 library on top of MFEM).  The reference's
one big idea — write a scalar energy
density at a quadrature point and get the element energy, residual (via
forward-mode dual-number AD), and Jacobian (via nested duals) for free —
maps one-to-one onto JAX: an energy is a plain Python function
``f(x, params) -> scalar`` and the residual/Jacobian come from
``jax.grad`` / ``jax.hessian`` vmapped over ``[n_elem, n_qp]`` batches.

Layer map (cf. reference SURVEY.md §1):

=========  ======================================  =======================
reference  this package                            notes
=========  ======================================  =======================
MFEM       ``mesh`` ``fespace`` ``quadrature``     arrays, not objects
           ``basis`` ``geometry``
ad_native  ``ad``                                  jax.grad/hessian
ad_intg    ``adeval`` ``integrator`` ``forms``     batched einsum assembly
pg/dof_pg  ``pg`` ``dof_pg``                       jit-compiled LVPP loop
mmto       ``mmto``                                completed (ref stubbed)
tools/log  ``utils``                               TableLogger, VTK, ckpt
MPI/hypre  ``parallel``                            shard_map + psum
=========  ======================================  =======================
"""

import os

import jax

# Finite elements need f64 for the reference's 1e-8..1e-10 tolerances
# (ex2.cpp:83, ex4.cpp:172).  Opt out with MFEM_AD_TPU_NO_X64=1 — the
# performance-critical kernels are dtype-generic and benched in f32.
if not os.environ.get("MFEM_AD_TPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

# An f32 matmul on the GPU may run in TF32 (10-bit mantissa) unless the
# precision is "highest", which injects ~1e-3 relative noise into
# residual evaluation and Krylov iterations — fatal for Newton
# convergence.  FEM needs true-f32 contractions; the assembly GEMMs that
# tolerate TF32 ask for Precision.HIGH explicitly (integrator.py).
# Override with MFEM_AD_TPU_MATMUL_PRECISION={default,high}.
_prec = os.environ.get("MFEM_AD_TPU_MATMUL_PRECISION", "highest")
if _prec != "default":
    jax.config.update("jax_default_matmul_precision", _prec)

# Persistent compilation cache: the LVPP solves compile dozens of
# programs, and every program is re-usable across runs.  Where
# JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing is set
# here; otherwise the cache lives at <checkout>/.jax_cache, a fixed path
# (the path is part of the cache key).
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir", os.path.join(CHECKOUT, ".jax_cache")
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from . import quadrature, basis, mesh, geometry, fespace  # noqa: E402
from .ad import (  # noqa: E402
    ADFunction,
    ADVectorFunction,
    MassEnergy,
    DiffusionEnergy,
    DiffEnergy,
    LinearElasticityEnergy,
    Lagrangian,
    ALFunctional,
    EmptyEnergy,
    admax,
    admin,
)
from .adeval import ADEval  # noqa: E402
from .coefficients import (  # noqa: E402
    Coefficient,
    ConstantCoefficient,
    FunctionCoefficient,
    GridFunctionCoefficient,
    GridFunctionValueCoefficient,
    MappedGridFunctionCoefficient,
    VectorGradientGridFunction,
    VectorNormCoefficient,
    BooleanCoefficient,
    DifferentiableCoefficient,
    QPContext,
    qp_context,
)
from .fespace import qspace_to_fespace  # noqa: E402
from .forms import NonlinearForm, BlockNonlinearForm, LinearForm  # noqa: E402
from .pg import (  # noqa: E402
    PGStepSizeRule,
    ADPGFunctional,
    ADLambdaPGFunctional,
    ShannonEntropy,
    FermiDiracEntropy,
    HellingerEntropy,
    SimplexEntropy,
    PGSolver,
)

__version__ = "0.1.0"
