"""CODANO: the Codomain Attention Neural Operator (port of
``neuraloperator_tpu/models/codano.py``).

Each physical variable is a token function: per-variable lifting, optional
Fourier-space positional encodings per variable id (``pos_enc_{vid}``) and
a CLS token (``cls_token``), a stack of ``CODALayer``s (``attention_{i}``)
with optional horizontal skips (``skip_map_{k}``), and per-variable
projection. ``extend_variable_ids`` grows a trained model to new variables.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .._common import resolve_device
from ..layers import _init
from ..layers.channel_mlp import ChannelMLP, gelu
from ..layers.coda_layer import CODALayer
from ..layers.padding import DomainPadding
from ..layers.resample import resample
from ..layers.spectral_convolution import SpectralConv
from ..ops.fourier import irfftn_pocketfft
from .base_model import register_model


@register_model(name="CODANO")
class CODANO(nn.Module):
    """``forward(x, static_channel=None, input_variable_ids=None)``:
    x (b, variables, d1..dN) -> (b, variables * output_variable_codimension,
    o1..oN)."""

    def __init__(
        self,
        n_modes: Optional[Sequence[Sequence[int]]] = None,
        output_variable_codimension: int = 1,
        lifting_channels: Optional[int] = 64,
        hidden_variable_codimension: int = 32,
        projection_channels: Optional[int] = 64,
        use_positional_encoding: bool = False,
        positional_encoding_dim: int = 8,
        positional_encoding_modes: Optional[Sequence[int]] = None,
        static_channel_dim: int = 0,
        variable_ids: Optional[Sequence[str]] = None,
        use_horizontal_skip_connection: bool = False,
        horizontal_skips_map: Optional[Dict[int, int]] = None,
        n_layers: int = 4,
        per_layer_scaling_factors: Optional[Sequence] = None,
        n_heads: Optional[Sequence[int]] = None,
        attention_scaling_factors: Optional[Sequence[float]] = None,
        conv_module: type = SpectralConv,
        nonlinear_attention: bool = False,
        non_linearity=gelu,
        attention_token_dim: int = 1,
        per_channel_attention: bool = False,
        domain_padding: Optional[float] = 0.25,
        enable_cls_token: bool = False,
        enforce_hermitian_symmetry: bool = True,
        *,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        del use_horizontal_skip_connection  # the JAX module reads horizontal_skips_map only
        if n_modes is None or len(n_modes) != n_layers:
            raise ValueError("CODANO needs n_modes with one entry per layer")
        if use_positional_encoding and variable_ids is None:
            raise ValueError("use_positional_encoding needs variable_ids")
        device = resolve_device(device)
        self.n_dim = n_dim = len(n_modes[0])
        self.n_layers = n_layers
        self.output_variable_codimension = output_variable_codimension
        self.use_positional_encoding = use_positional_encoding
        self.positional_encoding_dim = positional_encoding_dim
        self.static_channel_dim = static_channel_dim
        self.variable_ids = tuple(variable_ids) if variable_ids is not None else None
        self.enable_cls_token = enable_cls_token
        self.extended_codim = (1 + static_channel_dim
                               + (positional_encoding_dim if use_positional_encoding else 0))
        self.hidden_codim = (self.extended_codim if lifting_channels is None
                             else hidden_variable_codimension)
        self.skips_map = {int(k): int(v) for k, v in dict(horizontal_skips_map or {}).items()}
        per_layer = per_layer_scaling_factors or [[1] * n_dim] * n_layers
        self.end_to_end_scaling = [1.0] * n_dim
        if per_layer_scaling_factors is not None:
            for s in per_layer_scaling_factors:
                s = [s] * n_dim if isinstance(s, (int, float)) else list(s)
                self.end_to_end_scaling = [a * b for a, b in zip(self.end_to_end_scaling, s)]
        modes = list(positional_encoding_modes if positional_encoding_modes is not None
                     else n_modes[0])
        modes[-1] = modes[-1] // 2
        self.pe_modes = tuple(max(m, 1) for m in modes)
        heads = n_heads or [1] * n_layers
        att_scales = attention_scaling_factors or [1.0] * n_layers
        kw = dict(device=device, generator=generator)

        self.lifting = None
        if lifting_channels is not None:
            self.lifting = ChannelMLP(self.extended_codim, out_channels=self.hidden_codim,
                                      hidden_channels=lifting_channels, n_layers=2, **kw)
        for i in range(n_layers):
            rsf = per_layer[i]
            self.add_module(f"attention_{i}", CODALayer(
                n_modes[i], n_heads=heads[i], scale=att_scales[i],
                token_codimension=attention_token_dim,
                per_channel_attention=per_channel_attention,
                resolution_scaling_factor=rsf[0] if isinstance(rsf, (tuple, list)) else rsf,
                nonlinear_attention=nonlinear_attention, non_linearity=non_linearity,
                conv_module=conv_module, enforce_hermitian_symmetry=enforce_hermitian_symmetry,
                **kw))
        for k in self.skips_map:
            self.add_module(f"skip_map_{k}", ChannelMLP(
                2 * self.hidden_codim, out_channels=self.hidden_codim,
                hidden_channels=2 * self.hidden_codim, n_layers=1, **kw))
        self.projection = None
        if projection_channels is not None:
            self.projection = ChannelMLP(self.hidden_codim,
                                         out_channels=output_variable_codimension,
                                         hidden_channels=projection_channels, n_layers=2, **kw)
        if enable_cls_token:
            self.cls_token = _init.normal((2, self.hidden_codim, *self.pe_modes), 1.0, device,
                                          generator)
        if use_positional_encoding:
            for vid in self.variable_ids:
                self.register_parameter(f"pos_enc_{vid}", _init.normal(
                    (2, positional_encoding_dim, *self.pe_modes), 1.0, device, generator))
        self.domain_padding = None
        if domain_padding is not None and domain_padding > 0:
            self.domain_padding = DomainPadding(
                domain_padding, resolution_scaling_factor=self.end_to_end_scaling)

    def _irfft_param(self, storage: torch.Tensor, spatial_shape) -> torch.Tensor:
        """A (2, c, modes...) parameter as the real function of
        ``spatial_shape`` whose low rFFT modes it holds."""
        half = list(spatial_shape)
        half[-1] = half[-1] // 2 + 1
        parts = []
        for part in (storage[0], storage[1]):
            pads = []
            for dim, target in zip(reversed(part.shape[1:]), reversed(half)):
                pads += [0, max(target - dim, 0)]
            part = nn.functional.pad(part, pads)
            parts.append(part[(slice(None), *(slice(0, t) for t in half))])
        return irfftn_pocketfft(torch.complex(parts[0], parts[1]), list(spatial_shape))

    def _extend_variables(self, x, static_channel, input_variable_ids):
        # (b, vars, spatial) -> (b, vars, extended_codim, spatial)
        x = x[:, :, None]
        if static_channel is not None:
            sc = static_channel[:, None].expand(x.shape[0], x.shape[1],
                                                *static_channel.shape[1:])
            x = torch.cat([x, sc], dim=2)
        if self.use_positional_encoding:
            pes = torch.stack([self._irfft_param(getattr(self, f"pos_enc_{vid}"),
                                                 x.shape[-self.n_dim:])
                               for vid in input_variable_ids])  # (vars, pe_dim, spatial)
            x = torch.cat([x, pes[None].expand(x.shape[0], *pes.shape)], dim=2)
        return x

    def forward(self, x: torch.Tensor, static_channel: Optional[torch.Tensor] = None,
                input_variable_ids: Optional[List[str]] = None) -> torch.Tensor:
        batch, num_inp_var, *spatial = x.shape
        if self.static_channel_dim > 0 and (
                static_channel is None or static_channel.shape[1] != self.static_channel_dim):
            raise ValueError(f"CODANO needs a static_channel of {self.static_channel_dim} "
                             "channels")
        if self.use_positional_encoding and (
                input_variable_ids is None or len(input_variable_ids) != num_inp_var):
            raise ValueError("CODANO needs one input_variable_id per input variable")
        x = self._extend_variables(x, static_channel, input_variable_ids)
        hidden = self.hidden_codim
        if self.lifting is not None:
            x = self.lifting(x.reshape(batch * num_inp_var, self.extended_codim, *spatial))
        x = x.reshape(batch, num_inp_var * hidden, *spatial)
        if self.enable_cls_token:
            cls = self._irfft_param(self.cls_token, tuple(spatial))
            x = torch.cat([cls[None].expand(batch, *cls.shape), x], dim=1)
            num_inp_var += 1
        if self.domain_padding is not None:
            x = self.domain_padding.pad(x)
        output_shape = tuple(int(round(i * j)) for i, j in
                             zip(x.shape[-self.n_dim:], self.end_to_end_scaling))
        skip_outputs = {}
        for i in range(self.n_layers):
            if i in self.skips_map:
                grid = tuple(x.shape[-self.n_dim:])
                skip_val = skip_outputs[self.skips_map[i]]
                t = resample(skip_val,
                             [m / n for m, n in zip(grid, skip_val.shape[-self.n_dim:])],
                             list(range(-self.n_dim, 0)), output_shape=grid)
                h = torch.cat([x.reshape(batch * num_inp_var, hidden, *grid),
                               t.reshape(batch * num_inp_var, hidden, *grid)], dim=1)
                x = getattr(self, f"skip_map_{i}")(h).reshape(batch, num_inp_var * hidden,
                                                               *grid)
            last = i == self.n_layers - 1
            x = getattr(self, f"attention_{i}")(x, output_shape=output_shape if last else None)
            if i in self.skips_map.values():
                skip_outputs[i] = x
        if self.domain_padding is not None:
            x = self.domain_padding.unpad(x)
        if self.projection is not None:
            x = self.projection(x.reshape(batch * num_inp_var, hidden,
                                          *x.shape[-self.n_dim:]))
            x = x.reshape(batch, num_inp_var * self.output_variable_codimension,
                          *x.shape[-self.n_dim:])
        if self.enable_cls_token:
            x = x[:, self.output_variable_codimension:]
        return x


def extend_variable_ids(model: CODANO, state_dict, new_variable_ids,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[CODANO, Dict[str, torch.Tensor]]:
    """Grow a trained CODANO to unseen variables, without touching ``model``.

    Returns ``(new_model, new_state_dict)``: ``new_model`` declares the
    union of the variable ids (the new ones deduplicated, in order), and
    ``new_state_dict`` holds every tensor of ``state_dict`` as it is plus a
    fresh unit-normal Fourier-space positional encoding per added id, drawn
    on the CPU from ``generator``; ``new_model`` holds a copy of it, so the
    outputs for the variables it knew are equal to the bit.
    """
    if not model.use_positional_encoding or model.variable_ids is None:
        raise ValueError("extend_variable_ids requires use_positional_encoding=True")
    seen, added = set(model.variable_ids), []
    for v in new_variable_ids:
        if v not in seen:
            seen.add(v)
            added.append(v)
    device = next(model.parameters()).device
    kwargs = dict(model._init_kwargs, variable_ids=tuple(model.variable_ids) + tuple(added))
    new_state = dict(state_dict)
    shape = (2, model.positional_encoding_dim, *model.pe_modes)
    for vid in added:
        new_state[f"pos_enc_{vid}"] = torch.randn(shape, generator=generator).to(device)
    new_model = type(model)(**kwargs, device="meta").to_empty(device=device)
    new_model.load_state_dict(new_state)
    return new_model.train(model.training), new_state
