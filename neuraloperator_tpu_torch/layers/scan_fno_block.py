"""Scan-over-layers Fourier blocks (port of ``neuraloperator_tpu/layers/scan_fno_block.py``).

The JAX module runs one traced layer under ``nn.scan``, its parameters
stacked on a leading ``n_layers`` axis. The port keeps that parameter
layout under the JAX names (``layers.conv.w_weight`` of shape
``(n_layers, 2, C, C, m1, m2)``, ``layers.fno_skip.weight``,
``layers.channel_mlp_skip.weight``, ``layers.channel_mlp.w0`` ...), so
checkpoints and optimizer states map one to one, and loops over the layers
in Python: each layer runs the port's layer modules on its slices of the
stacked parameters (``torch.func.functional_call``). The JAX layer's
quirks are kept: its spectral convolution computes in "full" precision
whatever the model's ``fno_block_precision``, its channel MLP uses GELU
and no dropout, the last layer skips both activations (JAX gates them with
``jnp.where(not_last, ...)``; here the layer index decides, which selects
the same values), and each layer's output is cast back to its input's dtype.
"""

from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .channel_mlp import ChannelMLP, gelu
from .skip_connections import skip_connection
from .spectral_convolution import SpectralConv


class _ScanLayer(nn.Module):
    """One Fourier layer, the body of the JAX scan, whose parameters are
    held stacked over ``n_layers``; ``forward`` runs on one layer's slices."""

    def __init__(self, channels: int, n_modes: Sequence[int], fno_skip: str,
                 channel_mlp_skip: str, channel_mlp_expansion: float, non_linearity: Callable,
                 max_n_modes: Optional[Sequence[int]], weight_dtype: str, n_layers: int, *,
                 device, generator: Optional[torch.Generator]):
        super().__init__()
        self.non_linearity = non_linearity
        n_dim = len(n_modes)

        def layer() -> dict:
            # one layer's modules, drawn as the unrolled layer draws them
            return {
                "conv": SpectralConv(channels, channels, n_modes, max_n_modes=max_n_modes,
                                     weight_dtype=weight_dtype, device=device,
                                     generator=generator),
                "fno_skip": skip_connection(channels, channels, n_dim=n_dim, skip_type=fno_skip,
                                            device=device, generator=generator),
                "channel_mlp_skip": skip_connection(channels, channels, n_dim=n_dim,
                                                    skip_type=channel_mlp_skip, device=device,
                                                    generator=generator),
                "channel_mlp": ChannelMLP(channels,
                                          hidden_channels=round(channels * channel_mlp_expansion),
                                          device=device, generator=generator),
            }

        layers = [layer() for _ in range(n_layers)]
        for name, module in layers[0].items():
            for key, _ in list(module.named_parameters(recurse=False)):
                stacked = torch.stack([getattr(each[name], key).detach() for each in layers])
                setattr(module, key, nn.Parameter(stacked))
            self.add_module(name, module)

    def forward(self, x: torch.Tensor, not_last: bool) -> torch.Tensor:
        in_dtype = x.dtype  # the JAX scan's carry keeps its dtype across layers
        x_skip_fno = self.fno_skip(x)
        x_skip_mlp = self.channel_mlp_skip(x)
        x = self.conv(x) + x_skip_fno
        if not_last:
            x = self.non_linearity(x)
        x = self.channel_mlp(x) + x_skip_mlp
        if not_last:
            x = self.non_linearity(x)
        return x.to(in_dtype)


class ScanFNOBlocks(nn.Module):
    """``n_layers`` Fourier layers with stacked parameters; ``forward(x)`` runs all.

    With ``remat`` each layer is a checkpoint (``torch.utils.checkpoint``):
    its activations are recomputed in the backward, as ``nn.remat`` of the
    scanned layer recomputes them.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        n_modes: Sequence[int],
        n_layers: int = 4,
        fno_skip: str = "linear",
        channel_mlp_skip: str = "soft-gating",
        channel_mlp_expansion: float = 0.5,
        non_linearity: Callable = gelu,
        max_n_modes: Optional[Sequence[int]] = None,
        weight_dtype: str = "float32",
        remat: bool = False,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if in_channels != out_channels:
            raise ValueError("scan-over-layers requires in_channels == out_channels")
        self.n_layers = n_layers
        self.remat = remat
        self.layers = _ScanLayer(in_channels, n_modes, fno_skip, channel_mlp_skip,
                                 channel_mlp_expansion, non_linearity, max_n_modes,
                                 weight_dtype, n_layers, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        names, stacked = zip(*self.layers.named_parameters())
        # one unbind per parameter: its backward stacks the layers' gradients once
        per_layer = zip(*(p.unbind(0) for p in stacked))
        for i, tensors in enumerate(per_layer):
            x = run_layer(self.layers, dict(zip(names, tensors)), x,
                          (i < self.n_layers - 1,), self.remat)
        return x


def run_layer(module: nn.Module, params: dict, x: torch.Tensor, args: tuple,
              remat: bool) -> torch.Tensor:
    """``module(x, *args)`` on ``params`` (``torch.func.functional_call``);
    with ``remat``, and only where autograd records, as a checkpoint.

    The checkpoint recomputes the call in the backward on the same
    ``params`` it was given, so the recompute sees the tensors the forward
    saw (the half policy's bf16 copies included). The layers draw no random
    numbers (dropout never fires in a forward of the package), so the RNG
    state is not saved and restored: that is exact, and it keeps the CUDA
    generator's state untouched inside a CUDA-graph capture.
    """
    def call(x):
        return torch.func.functional_call(module, params, (x, *args))

    if remat and torch.is_grad_enabled():
        return checkpoint(call, x, use_reentrant=False, preserve_rng_state=False)
    return call(x)
