"""Recurrent neural operator cell and block (port of
``neuraloperator_tpu/layers/rno_block.py``): a GRU in function space whose
gate maps are one-layer Fourier blocks,

    z  = sigmoid(f1(x) + f2(h) + b1)
    r  = sigmoid(f3(x) + f4(h) + b2)
    h~ = selu(f5(x) + f6(r * h) + b3)
    h' = (1 - z) * h + z * h~

The cell's submodules keep the JAX names ``input_gate_{0,1,2}`` (the f's of
x, which may rescale the grid), ``hidden_gate_{0,1,2}`` and the scalar
biases ``bias_{0,1,2}``; the block holds ``cell`` and the scalar
``bias_h`` that fills the initial hidden state. Every gate is an
``FNOBlocks(n_layers=1)``, so each launches the mode contraction once per
call.
"""

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ._init import normal
from .channel_mlp import gelu
from .fno_block import FNOBlocks
from .spectral_convolution import SpectralConv


class RNOCell(nn.Module):
    """``forward(x, h)``: one GRU update of the hidden state ``h`` (b, c,
    *grid) from the input ``x`` (b, c, *grid of x); ``x`` is rescaled to
    ``h``'s grid by ``resolution_scaling_factor``."""

    def __init__(
        self,
        n_modes: Sequence[int],
        hidden_channels: int,
        resolution_scaling_factor=None,
        max_n_modes: Optional[Sequence[int]] = None,
        fno_block_precision: str = "full",
        use_channel_mlp: bool = True,
        channel_mlp_dropout: float = 0.0,
        channel_mlp_expansion: float = 0.5,
        non_linearity: Callable = gelu,
        stabilizer: Optional[str] = None,
        norm: Optional[str] = None,
        norm_groups: int = 1,
        preactivation: bool = False,
        fno_skip: Optional[str] = "linear",
        channel_mlp_skip: Optional[str] = "soft-gating",
        complex_data: bool = False,
        separable: bool = False,
        factorization: Optional[str] = None,
        rank=1.0,
        conv_module: type = SpectralConv,
        fixed_rank_modes: bool = False,
        implementation: str = "factorized",
        enforce_hermitian_symmetry: bool = True,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        kwargs = dict(
            n_layers=1, max_n_modes=max_n_modes, fno_block_precision=fno_block_precision,
            use_channel_mlp=use_channel_mlp, channel_mlp_dropout=channel_mlp_dropout,
            channel_mlp_expansion=channel_mlp_expansion, non_linearity=non_linearity,
            stabilizer=stabilizer, norm=norm, norm_groups=norm_groups,
            preactivation=preactivation, fno_skip=fno_skip, channel_mlp_skip=channel_mlp_skip,
            complex_data=complex_data, separable=separable, factorization=factorization,
            rank=rank, conv_module=conv_module, fixed_rank_modes=fixed_rank_modes,
            implementation=implementation, enforce_hermitian_symmetry=enforce_hermitian_symmetry,
            device=device, generator=generator,
        )
        scaling = resolution_scaling_factor or None
        for i in range(3):
            self.add_module(f"input_gate_{i}", FNOBlocks(
                hidden_channels, hidden_channels, tuple(n_modes),
                resolution_scaling_factor=scaling, **kwargs))
        for i in range(3):
            self.add_module(f"hidden_gate_{i}", FNOBlocks(
                hidden_channels, hidden_channels, tuple(n_modes),
                resolution_scaling_factor=None, **kwargs))
        for i in range(3):
            self.register_parameter(f"bias_{i}", normal((), 1.0, device, generator))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        update = torch.sigmoid(self.input_gate_0(x) + self.hidden_gate_0(h) + self.bias_0)
        reset = torch.sigmoid(self.input_gate_1(x) + self.hidden_gate_1(h) + self.bias_1)
        combined = self.input_gate_2(x) + self.hidden_gate_2(reset * h) + self.bias_2
        candidate = torch.nn.functional.selu(combined)
        return (1.0 - update) * h + update * candidate


class RNOBlock(nn.Module):
    """``forward(x, h=None)``: the cell over a (b, t, c, *grid) sequence from
    ``h`` (``bias_h`` everywhere when None, on the rescaled grid); the last
    hidden state, or every one stacked on axis 1 with
    ``return_sequences``."""

    def __init__(
        self,
        n_modes: Sequence[int],
        hidden_channels: int,
        return_sequences: bool = False,
        resolution_scaling_factor=None,
        max_n_modes: Optional[Sequence[int]] = None,
        fno_block_precision: str = "full",
        use_channel_mlp: bool = True,
        channel_mlp_dropout: float = 0.0,
        channel_mlp_expansion: float = 0.5,
        non_linearity: Callable = gelu,
        stabilizer: Optional[str] = None,
        norm: Optional[str] = None,
        norm_groups: int = 1,
        preactivation: bool = False,
        fno_skip: Optional[str] = "linear",
        channel_mlp_skip: Optional[str] = "soft-gating",
        complex_data: bool = False,
        separable: bool = False,
        factorization: Optional[str] = None,
        rank=1.0,
        conv_module: type = SpectralConv,
        fixed_rank_modes: bool = False,
        implementation: str = "factorized",
        enforce_hermitian_symmetry: bool = True,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.return_sequences = return_sequences
        self.resolution_scaling_factor = resolution_scaling_factor
        self.cell = RNOCell(
            n_modes, hidden_channels, resolution_scaling_factor=resolution_scaling_factor,
            max_n_modes=max_n_modes, fno_block_precision=fno_block_precision,
            use_channel_mlp=use_channel_mlp, channel_mlp_dropout=channel_mlp_dropout,
            channel_mlp_expansion=channel_mlp_expansion, non_linearity=non_linearity,
            stabilizer=stabilizer, norm=norm, norm_groups=norm_groups,
            preactivation=preactivation, fno_skip=fno_skip, channel_mlp_skip=channel_mlp_skip,
            complex_data=complex_data, separable=separable, factorization=factorization,
            rank=rank, conv_module=conv_module, fixed_rank_modes=fixed_rank_modes,
            implementation=implementation, enforce_hermitian_symmetry=enforce_hermitian_symmetry,
            device=device, generator=generator,
        )
        self.bias_h = normal((), 1.0, device, generator)

    def forward(self, x: torch.Tensor, h: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch, timesteps = x.shape[:2]
        if h is None:
            grid = x.shape[3:]
            if self.resolution_scaling_factor:
                grid = [int(round(self.resolution_scaling_factor * s)) for s in grid]
            h = torch.zeros((batch, self.hidden_channels, *grid), dtype=x.dtype,
                            device=x.device) + self.bias_h
        outputs = []
        for t in range(timesteps):
            h = self.cell(x[:, t], h)
            if self.return_sequences:
                outputs.append(h)
        if self.return_sequences:
            return torch.stack(outputs, dim=1)
        return h
