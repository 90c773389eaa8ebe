"""cuddhelmholtz_tpu_torch: the PyTorch + CUDA port of ``cuddhelmholtz_tpu``.

The JAX package stays the reference; this package mirrors its layout so each
counterpart is easy to find:

  utils/      quadrature rules, nodal bases, ``norm``       (NumPy float64 setup)
  mesh/       Mesh2D geometry + metric caches
  spaces/     H1Space, EnsembleSpace (subdomain tables, ``cmap``)
  ops/        lumped mass, collocation functional; ops/cuda: the Hopper
              WaveHoltz kernel (``csrc/wave_cycle.cu``) and its plain version
  models/     Helmholtz forcing
  solvers/    GMRES(m), the DDH preconditioner (direct path)
  examples/   ``run_ddh``

It imports ``torch`` and never ``jax``.  Host setup runs in NumPy float64 as
the JAX package does; device state is float32.
"""

import torch as _torch

# Counterpart of the JAX package's ``jax_default_matmul_precision="highest"``:
# the wave cycle needs fp32-grade products (a single reduced-precision pass
# stalls lambda-GMRES above its 1e-4 tolerance), so TF32 stays off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
