"""cuddhelmholtz_tpu_torch: the PyTorch + CUDA port of ``cuddhelmholtz_tpu``.

The JAX package stays the reference; this package mirrors its layout so each
counterpart is easy to find:

  utils/      quadrature rules, nodal bases, ``norm``       (NumPy float64 setup)
  mesh/       Mesh2D geometry + element/edge metric caches, mesh files, refinement
  spaces/     H1Space, FaceSpace, EnsembleSpace (subdomain tables, ``cmap``)
  ops/        matrix-free stiffness, mass and face mass, the structured grid
              numbering (GridH1Space) and kron fast path, functionals;
              ops/cuda: the Hopper WaveHoltz kernels
              (``csrc/wave_cycle_sparse.cu``, S's non-zeros in shared memory,
              the default; the dense ``csrc/wave_cycle.cu``, S resident, and
              ``csrc/wave_cycle_streamed.cu``, S streamed) and their plain
              version
  models/     the coupled Helmholtz operator, coefficient projection, Poisson
  solvers/    GMRES(m) and flexible GMRES(m), the DDH preconditioner (direct
              and transfer/io paths)
  examples/   ``run_poisson``, ``run_helmholtz``, ``run_ddh``,
              ``run_helmholtz_ddh``, ``run_config``, ``large_unstructured``,
              ``profile_solve``

It imports ``torch`` and never ``jax``.  Host setup runs in NumPy float64 as
the JAX package does; the DDH's device state is float32, the global
operators run in the dtype they are built with.
"""

import torch as _torch

# Counterpart of the JAX package's ``jax_default_matmul_precision="highest"``:
# the wave cycle needs fp32-grade products (a single reduced-precision pass
# stalls lambda-GMRES above its 1e-4 tolerance), so TF32 stays off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
