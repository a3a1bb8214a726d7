from . import device  # noqa: F401
from .linop import (AdjointOperator, DenseOperator, LinearOperator,
                    aslinearoperator)

__all__ = ["AdjointOperator", "DenseOperator", "LinearOperator",
           "aslinearoperator"]
