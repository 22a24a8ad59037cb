from .data_losses import H1Loss, HdivLoss, LpLoss, MSELoss, PointwiseQuantileLoss
from .differentiation import (
    FiniteDiff,
    FourierDiff,
    central_diff_1d,
    central_diff_2d,
    central_diff_3d,
    get_non_uniform_fd_weights,
    non_uniform_fd,
)
from .equation_losses import (
    BurgersEqnLoss,
    ICLoss,
    PoissonBoundaryLoss,
    PoissonEqnLoss,
    PoissonInteriorLoss,
)
from .meta_losses import Aggregator, FieldwiseAggregatorLoss, Relobralo, SoftAdapt, WeightedSumLoss

__all__ = ["Aggregator", "BurgersEqnLoss", "FieldwiseAggregatorLoss", "FiniteDiff", "FourierDiff",
           "H1Loss", "HdivLoss", "ICLoss", "LpLoss", "MSELoss", "PointwiseQuantileLoss",
           "PoissonBoundaryLoss", "PoissonEqnLoss", "PoissonInteriorLoss", "Relobralo",
           "SoftAdapt", "WeightedSumLoss", "central_diff_1d", "central_diff_2d",
           "central_diff_3d", "get_non_uniform_fd_weights", "non_uniform_fd"]
