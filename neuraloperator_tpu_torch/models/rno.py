"""Recurrent Neural Operator (port of ``neuraloperator_tpu/models/rno.py``).

Grid embedding and lifting of every frame -> optional domain padding ->
``n_layers`` ``RNOBlock``s over the (batch, time, channel, *grid) sequence
(each but the last returns its whole sequence, added to its input with
``rno_skip``) -> unpadding -> projection of the last hidden state.
``predict`` rolls the model out step by step on the host, each
prediction the next input, the hidden states carried over.
"""

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from .._common import resolve_device
from ..layers.channel_mlp import ChannelMLP, gelu
from ..layers.embeddings import GridEmbeddingND
from ..layers.padding import domain_padding_or_none
from ..layers.rno_block import RNOBlock
from ..layers.spectral_convolution import SpectralConv
from .base_model import register_model


@register_model(name="RNO")
class RNO(nn.Module):
    """``forward(x, init_hidden_states=None, return_hidden_states=False)``:
    (b, t, in, *grid) -> (b, out, *grid'), and with ``return_hidden_states``
    also each layer's final state (the inputs of the next layer's last
    frame, the last layer's output), unpadded.

    ``device`` defaults to ``"cuda"`` and raises when there is no card
    unless ``device="cpu"`` is passed. Weights are drawn on the CPU from
    ``generator``, then moved.
    """

    def __init__(
        self,
        n_modes: Sequence[int],
        in_channels: int,
        out_channels: int,
        hidden_channels: int,
        n_layers: int = 4,
        lifting_channel_ratio: float = 2,
        projection_channel_ratio: float = 2,
        positional_embedding: Optional[str] = "grid",
        non_linearity: Callable = gelu,
        norm: Optional[str] = None,
        norm_groups: int = 1,
        complex_data: bool = False,
        use_channel_mlp: bool = True,
        channel_mlp_dropout: float = 0.0,
        channel_mlp_expansion: float = 0.5,
        channel_mlp_skip: Optional[str] = "soft-gating",
        fno_skip: Optional[str] = "linear",
        rno_skip: bool = True,
        return_sequences: bool = False,
        resolution_scaling_factor=None,
        domain_padding=None,
        fno_block_precision: str = "full",
        stabilizer: Optional[str] = None,
        max_n_modes: Optional[Sequence[int]] = None,
        factorization: Optional[str] = None,
        rank=1.0,
        fixed_rank_modes: bool = False,
        implementation: str = "factorized",
        separable: bool = False,
        preactivation: bool = False,
        conv_module: type = SpectralConv,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        n_modes = tuple(int(m) for m in n_modes)
        self.n_dim = len(n_modes)
        self.in_channels = in_channels
        self.n_layers = n_layers
        self.rno_skip = rno_skip
        self.embedding = (GridEmbeddingND(in_channels, dim=self.n_dim)
                          if positional_embedding == "grid" else None)
        kw = dict(device=device, generator=generator)
        self.lifting = ChannelMLP(
            in_channels + (self.n_dim if self.embedding is not None else 0),
            out_channels=hidden_channels,
            hidden_channels=int(lifting_channel_ratio * hidden_channels),
            n_layers=2, non_linearity=non_linearity, **kw)
        return_seq = [True] * (n_layers - 1) + [return_sequences]
        for i in range(n_layers):
            self.add_module(f"rno_block_{i}", RNOBlock(
                n_modes, hidden_channels, return_sequences=return_seq[i],
                resolution_scaling_factor=resolution_scaling_factor, max_n_modes=max_n_modes,
                fno_block_precision=fno_block_precision, use_channel_mlp=use_channel_mlp,
                channel_mlp_dropout=channel_mlp_dropout,
                channel_mlp_expansion=channel_mlp_expansion, non_linearity=non_linearity,
                stabilizer=stabilizer, norm=norm, norm_groups=norm_groups,
                preactivation=preactivation, fno_skip=fno_skip,
                channel_mlp_skip=channel_mlp_skip, complex_data=complex_data,
                separable=separable, factorization=factorization, rank=rank,
                conv_module=conv_module, fixed_rank_modes=fixed_rank_modes,
                implementation=implementation, **kw))
        self.projection = ChannelMLP(
            hidden_channels, out_channels=out_channels,
            hidden_channels=int(projection_channel_ratio * hidden_channels),
            n_layers=2, non_linearity=non_linearity, **kw)
        self.domain_padding = domain_padding_or_none(domain_padding, resolution_scaling_factor)

    def forward(self, x: torch.Tensor, init_hidden_states: Optional[List] = None,
                return_hidden_states: bool = False):
        expected_rank = 3 + self.n_dim
        if x.dim() != expected_rank:
            raise ValueError(
                f"RNO expects rank-{expected_rank} input (batch, time, channels, spatial...), "
                f"got shape {tuple(x.shape)}"
            )
        if x.shape[2] != self.in_channels:
            raise ValueError(
                f"RNO expects x.shape[2] == in_channels ({self.in_channels}), got {x.shape[2]}"
            )
        batch, timesteps = x.shape[:2]
        if init_hidden_states is None:
            init_hidden_states = [None] * self.n_layers

        flat = x.reshape(batch * timesteps, *x.shape[2:])
        if self.embedding is not None:
            flat = self.embedding(flat)
        flat = self.lifting(flat)
        if self.domain_padding is not None:
            flat = self.domain_padding.pad(flat)
        x_seq = flat.reshape(batch, timesteps, *flat.shape[1:])

        final_states = []
        for i in range(self.n_layers):
            pred = getattr(self, f"rno_block_{i}")(x_seq, init_hidden_states[i])
            if i < self.n_layers - 1:
                x_seq = x_seq + pred if self.rno_skip else pred
                final_states.append(x_seq[:, -1])
            else:
                x_seq = pred
                final_states.append(x_seq)
        h = final_states[-1]
        if self.domain_padding is not None:
            h = self.domain_padding.unpad(h)
            final_states = [self.domain_padding.unpad(s) for s in final_states]
        out = self.projection(h)
        if return_hidden_states:
            return out, final_states
        return out

    def predict(self, x: torch.Tensor, num_steps: int, grid_function=None) -> torch.Tensor:
        """``num_steps`` predictions, stacked on axis 1: each is the next
        step's input (with ``grid_function(shape)``'s channels appended
        when given), and each step starts from the last one's states."""
        outputs = []
        states = None
        for _ in range(num_steps):
            pred, states = self(x, init_hidden_states=states, return_hidden_states=True)
            outputs.append(pred)
            x = pred[:, None]
            if grid_function is not None:
                x = torch.cat([x, grid_function(x.shape)], dim=2)
        return torch.stack(outputs, dim=1)
