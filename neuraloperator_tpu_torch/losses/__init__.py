from .data_losses import H1Loss, HdivLoss, LpLoss, MSELoss, PointwiseQuantileLoss
from .differentiation import FiniteDiff

__all__ = ["FiniteDiff", "H1Loss", "HdivLoss", "LpLoss", "MSELoss", "PointwiseQuantileLoss"]
