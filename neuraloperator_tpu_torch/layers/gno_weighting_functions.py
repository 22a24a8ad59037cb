"""Mollifier weighting functions for mollified GNO layers (port of
``neuraloperator_tpu/layers/gno_weighting_functions.py``): smooth cutoffs of
the *squared* distance, scaled so the weight vanishes at the search radius."""

import math

import torch


def bump(sq_dist, radius: float, scale: float = 1.0):
    """The bump exp(1 - 1 / (1 - r² / R²)), zero outside."""
    r2 = sq_dist / (radius ** 2)
    inside = r2 < 1.0
    safe = torch.where(inside, r2, torch.zeros_like(r2))
    w = torch.exp(1.0 - 1.0 / torch.clamp(1.0 - safe, min=1e-12))
    return scale * torch.where(inside, w, torch.zeros_like(w))


def half_cos(sq_dist, radius: float, scale: float = 1.0):
    r = torch.sqrt(torch.clamp(sq_dist, min=0.0)) / radius
    return scale * torch.where(r < 1.0, torch.cos(0.5 * math.pi * r), torch.zeros_like(r))


def quadr(sq_dist, radius: float, scale: float = 1.0):
    r2 = sq_dist / (radius ** 2)
    return scale * torch.where(r2 < 1.0, 1.0 - r2, torch.zeros_like(r2))


def quartic(sq_dist, radius: float, scale: float = 1.0):
    r2 = sq_dist / (radius ** 2)
    return scale * torch.where(r2 < 1.0, (1.0 - r2) ** 2, torch.zeros_like(r2))


def octic(sq_dist, radius: float, scale: float = 1.0):
    r2 = sq_dist / (radius ** 2)
    return scale * torch.where(r2 < 1.0, (1.0 - r2) ** 4, torch.zeros_like(r2))


_WEIGHTING_FNS = {
    "bump": bump,
    "half_cos": half_cos,
    "quadr": quadr,
    "quartic": quartic,
    "octic": octic,
}


def dispatch_weighting_fn(name: str, sq_radius: float, scale: float = 1.0):
    """``w(sq_dist)`` of the named mollifier at radius ``sqrt(sq_radius)``."""
    try:
        fn = _WEIGHTING_FNS[name]
    except KeyError:
        raise ValueError(
            f"unknown weighting fn {name!r}; expected one of {sorted(_WEIGHTING_FNS)}"
        ) from None
    radius = float(sq_radius) ** 0.5

    def weight(sq_dist):
        return fn(sq_dist, radius=radius, scale=scale)

    return weight


# the reference's names
bump_cutoff = bump
half_cos_cutoff = half_cos
quadr_cutoff = quadr
quartic_cutoff = quartic
octic_cutoff = octic
