from .banded import BandedProjector
from .banded_buckets import BucketedBandedProjector
from .bsr import BsrOperator
from .csr import CsrOperator
from .dynamic_banded import (BucketedDynamicBandedOperator,
                             DynamicBandedOperator)
from .ell import EllOperator

__all__ = ["BsrOperator", "CsrOperator", "BandedProjector",
           "BucketedBandedProjector", "DynamicBandedOperator",
           "BucketedDynamicBandedOperator", "EllOperator"]
