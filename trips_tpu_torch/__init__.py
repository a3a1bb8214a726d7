"""trips-tpu-torch: the trips_tpu package on PyTorch and CUDA (NVIDIA H100).

Ported so far: the tomography CGLS path (phantoms, fan- and parallel-beam
matrices, bucketed banded operator with hand-written CUDA kernels, CGLS),
the matrix-free projectors (the shear-rotate fan projector with
hand-written CUDA kernels, the on-the-fly and shear-stack projectors), and
the regularized solvers of the tomography demo (Golub-Kahan and Arnoldi,
the derivative and weight operators, GCV/DP/L-curve, GKS, MMGKS, the hybrid
and projection solvers), dynamic CT (the flat, dynamic and CSR operators
over the same kernels, the dynamic problems and loaders), the
all-on-device solvers (fused GKS, MMGKS and hybrids with lam chosen on the
device, LSQR, checkpointed runs), and deblurring (the 1D and 2D blurs,
the framelet operator, the deblurring problems, the direct Tikhonov, TSVD
and TGSVD solvers with the GSVD, the linear-operator combinators, the
validation helpers), out-of-core and batched dynamic CT (``parallel``: the
streamed operator over the same kernels, the per-frame batched solve), the
operators sharded over ranks on ``torch.distributed`` (``parallel``: ELL,
BSR as CSR, and the static and dynamic banded packs over K1-K3, with the
meshes and the process-group start-up), ``config`` and
``utils.telemetry``. The JAX package ``trips_tpu`` is the
reference each part is tested against.
"""
import torch

from . import (config, core, krylov, operators, parallel,  # noqa: F401
               problems, regparam, solvers, sparse, utils)
from .core import LinearOperator, aslinearoperator  # noqa: F401

__version__ = "0.1.0"

# float32 products stay float32: the solvers are held against float32 and
# float64 references, and TF32 would drop mantissa bits on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# bf16 products sum in float32, as JAX's preferred_element_type=float32 does
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
