from . import device  # noqa: F401
from .linop import (AdjointOperator, BatchedBlockDiagOperator, DenseOperator,
                    IdentityOperator, LinearOperator, ScaledOperator,
                    aslinearoperator)

__all__ = ["AdjointOperator", "BatchedBlockDiagOperator", "DenseOperator",
           "IdentityOperator", "LinearOperator", "ScaledOperator",
           "aslinearoperator"]
