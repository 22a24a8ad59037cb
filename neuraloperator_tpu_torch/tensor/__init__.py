from .factorized import (
    FactorizationSpec,
    factor_shapes,
    init_factors,
    n_params,
    resolve_spec,
    slice_factors,
    to_tensor,
)

__all__ = ["FactorizationSpec", "factor_shapes", "init_factors", "n_params", "resolve_spec",
           "slice_factors", "to_tensor"]
