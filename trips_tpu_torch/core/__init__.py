from . import device  # noqa: F401
from .linop import (AdjointOperator, BatchedBlockDiagOperator,
                    BlockDiagOperator, CompositeOperator, DenseOperator,
                    FunctionOperator, IdentityOperator, LinearOperator,
                    ScaledOperator, VStackOperator, aslinearoperator)

__all__ = ["AdjointOperator", "BatchedBlockDiagOperator", "BlockDiagOperator",
           "CompositeOperator", "DenseOperator", "FunctionOperator",
           "IdentityOperator", "LinearOperator", "ScaledOperator",
           "VStackOperator", "aslinearoperator"]
