"""Domain padding for non-periodic inputs (port of
``neuraloperator_tpu/layers/padding.py``): symmetric zero padding by a
fraction of the resolution, removed again after the Fourier layers."""

from typing import List, Sequence, Union

import torch

from ..utils import validate_scaling_factor


class DomainPadding:
    """Symmetric fraction-of-resolution padding, channels first."""

    def __init__(
        self,
        domain_padding: Union[float, Sequence[float]],
        resolution_scaling_factor: Union[int, float, Sequence[float], None] = 1,
    ):
        self.domain_padding = domain_padding
        if resolution_scaling_factor is None:
            resolution_scaling_factor = 1
        self.resolution_scaling_factor = resolution_scaling_factor

    def _fractions(self, n_dim: int) -> List[float]:
        dp = self.domain_padding
        if isinstance(dp, (float, int)):
            return [float(dp)] * n_dim
        if len(dp) != n_dim:
            raise ValueError("domain_padding length must match the number of spatial dims")
        return list(dp)

    def _scaling(self, n_dim: int) -> List[float]:
        rsf = self.resolution_scaling_factor
        if isinstance(rsf, (list, tuple)):
            return [float(s) for s in rsf]
        return validate_scaling_factor(rsf, n_dim, n_layers=None)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        resolution = x.shape[2:]
        padding = [round(p * r) for p, r in zip(self._fractions(len(resolution)), resolution)]
        pads = []
        for p in reversed(padding):  # F.pad lists the last dim first
            pads += [p, p]
        return torch.nn.functional.pad(x, pads)

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        """Remove the padding, scaled by any resolution scaling since.

        The input resolution r is recovered per dim by the JAX package's
        search for the smallest r with ``round(s * (r + 2 * round(p * r)))``
        equal to the output size, so that rounding ties go its way.
        """
        out_res = x.shape[2:]
        n_dim = len(out_res)
        for dim, (o, s, p_frac) in enumerate(
                zip(out_res, self._scaling(n_dim), self._fractions(n_dim))):
            pad_out = None
            for r in range(1, o + 1):
                p_in = round(p_frac * r)
                if round(s * (r + 2 * p_in)) == o:
                    pad_out = round(s * p_in)
                    break
            if pad_out is None:  # the JAX fallback: a proportional estimate
                r_est = max(1, int(round(o / s / (1 + 2 * p_frac))))
                pad_out = round(s * round(p_frac * r_est))
            if pad_out:
                x = x.narrow(2 + dim, pad_out, max(o - 2 * pad_out, 0))
        return x

    __call__ = pad


def domain_padding_or_none(domain_padding, resolution_scaling_factor=1):
    """A ``DomainPadding`` when any fraction of ``domain_padding`` (a number
    or one per dim) is above 0, else None: how the models build theirs."""
    dp = domain_padding
    if dp is None or not (sum(dp) > 0 if isinstance(dp, (list, tuple)) else float(dp) > 0):
        return None
    return DomainPadding(list(dp) if isinstance(dp, (list, tuple)) else dp,
                         resolution_scaling_factor=resolution_scaling_factor)
