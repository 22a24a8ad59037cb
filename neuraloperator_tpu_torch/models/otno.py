"""OTNO, the optimal-transport neural operator (port of
``neuraloperator_tpu/models/otno.py``).

An FNO on OT-transported features over a square latent grid, whose output
is decoded back to the target mesh by the index gather ``ind_dec``; the OT
maps come from the data pipeline (``data/datasets/ot_datamodule.py``). Its
constructor is the FNO's with OTNO's defaults.
"""

import torch

from .base_model import register_model
from .fno import FNO, partialclass


@register_model(name="OTNO")
class OTNO(partialclass("OTNO", FNO, in_channels=4, out_channels=1, hidden_channels=64,
                        positional_embedding=None, use_channel_mlp=False,
                        channel_mlp_expansion=0.5, norm="group_norm")):
    """``forward(x, ind_dec)``: x (1, in_channels, s, s) transported
    features, ``ind_dec`` (n_t,) latent cell of each target point ->
    (out_channels, n_t)."""

    def forward(self, x: torch.Tensor, ind_dec: torch.Tensor) -> torch.Tensor:
        if self.embedding is not None:
            x = self.embedding(x)
        x = self.lifting(x)
        if self.domain_padding is not None:
            x = self.domain_padding.pad(x)
        for i in range(self.n_layers):
            x = self.fno_blocks(x, i)
        if self.domain_padding is not None:
            x = self.domain_padding.unpad(x)
        # back to the target mesh: the latent cell of each target point
        h = x.reshape(x.shape[1], -1).T  # (s*s, hidden)
        out = h[ind_dec].T[None]  # (1, hidden, n_t)
        return self.projection(out)[0]
