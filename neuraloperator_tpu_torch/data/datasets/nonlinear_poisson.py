"""Nonlinear Poisson point-cloud dataset, for GINO/FNOGNO with physics
losses (port of ``neuraloperator_tpu/data/datasets/nonlinear_poisson.py``;
the same numpy and scipy, so one seed gives the same samples to the bit).

Dict samples with input geometry, boundary and interior query points,
source terms and solution values. A compatible ``.pt`` archive is loaded if
given; otherwise samples are generated by solving a Poisson problem on a
grid (a finite-difference solve, scipy) and sampling point clouds from it.
"""

from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .tensor_dataset import DictDataset


def _generate_sample(rng: np.random.Generator, grid_n: int = 32,
                     n_interior: int = 256, n_boundary: int = 64):
    from scipy.sparse import lil_matrix
    from scipy.sparse.linalg import spsolve

    from .synthetic import gaussian_random_field

    f_grid = gaussian_random_field(rng, grid_n, alpha=3.0, tau=5.0) * 10

    # solve -Δu = f with u=0 on the boundary (linear proxy of the
    # reference's nonlinear problem; used for pipeline/smoke paths)
    n = grid_n
    h = 1.0 / (n + 1)
    A = lil_matrix((n * n, n * n))
    b = f_grid.reshape(-1) * h ** 2

    def idx(i, j):
        return i * n + j

    for i in range(n):
        for j in range(n):
            A[idx(i, j), idx(i, j)] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < n and 0 <= jj < n:
                    A[idx(i, j), idx(ii, jj)] = -1.0
    u = spsolve(A.tocsr(), b).reshape(n, n)

    xs = (np.arange(n) + 1) * h

    def interp(pts):
        i = np.clip((pts[:, 0] / h - 1).astype(int), 0, n - 1)
        j = np.clip((pts[:, 1] / h - 1).astype(int), 0, n - 1)
        return u[i, j]

    def interp_f(pts):
        i = np.clip((pts[:, 0] / h - 1).astype(int), 0, n - 1)
        j = np.clip((pts[:, 1] / h - 1).astype(int), 0, n - 1)
        return f_grid[i, j]

    interior = rng.uniform(h, 1 - h, size=(n_interior, 2))
    t = rng.uniform(0, 1, n_boundary)
    side = rng.integers(0, 4, n_boundary)
    boundary = np.zeros((n_boundary, 2))
    boundary[side == 0] = np.stack(
        [t[side == 0], np.zeros((side == 0).sum())], -1
    )
    boundary[side == 1] = np.stack(
        [t[side == 1], np.ones((side == 1).sum())], -1
    )
    boundary[side == 2] = np.stack(
        [np.zeros((side == 2).sum()), t[side == 2]], -1
    )
    boundary[side == 3] = np.stack(
        [np.ones((side == 3).sum()), t[side == 3]], -1
    )

    queries = np.concatenate([boundary, interior], 0).astype(np.float32)
    vals = np.concatenate(
        [np.zeros(n_boundary), interp(interior)], 0
    ).astype(np.float32)
    return {
        "input_geom": queries,
        "output_queries": queries,
        "y": vals[:, None],
        "x": interp_f(queries).astype(np.float32)[:, None],
        "num_boundary": np.int64(n_boundary),
        "output_source_terms_domain": interp_f(interior).astype(np.float32),
    }


class NonlinearPoissonDataset:
    """Point-cloud Poisson dataset (reference nonlinear_poisson.py:118+)."""

    def __init__(
        self,
        file_path: Optional[str] = None,
        n_train: int = 8,
        n_test: int = 2,
        seed: int = 0,
        **kwargs,
    ):
        if file_path is not None and Path(file_path).exists():
            raw = torch.load(str(file_path), weights_only=False)
            data = [
                {
                    k: (v.detach().cpu().numpy() if hasattr(v, "numpy") else v)
                    for k, v in entry.items()
                }
                for entry in raw
            ]
        else:
            rng = np.random.default_rng(seed)
            data = [_generate_sample(rng) for _ in range(n_train + n_test)]
        self.train_data = DictDataset(data[:n_train])
        self.test_data = DictDataset(data[n_train : n_train + n_test])


def generate_latent_queries(query_res: int, pad: int = 0,
                            domain_lims=((-1.4, 1.4), (-1.4, 1.4))):
    """Regular latent-grid query coordinates for GINO
    (reference nonlinear_poisson.py:18-55). Returns (d1, d2, dim)."""
    axes = []
    for lower, upper in domain_lims:
        mesh = np.linspace(lower, upper, query_res)
        if pad > 0:
            start = np.linspace(lower - pad / query_res, lower, pad + 1)
            stop = np.linspace(upper, upper + pad / query_res, pad + 1)
            mesh = np.concatenate([start, mesh, stop])
        axes.append(mesh)
    grid = np.stack(np.meshgrid(*axes, indexing="xy"))
    return np.moveaxis(grid, 0, -1).astype(np.float32)


def generate_output_queries(grid_res: int, coefs: dict,
                            domain_lims=((-1.4, 1.4), (-1.4, 1.4)),
                            tol: float = 1e-7):
    """Random output query coordinates inside the instance's domain
    (reference nonlinear_poisson.py:58-115). ``coefs`` may carry a
    callable ``inside`` predicate or a radius ``r``; absent both, the
    full rectangular domain is used."""
    rng = np.random.default_rng(int(coefs.get("seed", 0)))
    lows = np.array([d[0] for d in domain_lims], np.float32)
    highs = np.array([d[1] for d in domain_lims], np.float32)
    pts = rng.uniform(lows, highs, size=(grid_res * grid_res, len(domain_lims)))
    inside = coefs.get("inside")
    if callable(inside):
        pts = pts[inside(pts)]
    elif "r" in coefs:
        pts = pts[(pts ** 2).sum(-1) <= float(coefs["r"]) ** 2 * (1 + tol)]
    return pts.astype(np.float32)


class PoissonGINODataProcessor:
    """DefaultDataProcessor plus random domain/codomain subsampling,
    shaped for GINO's forward signature (reference
    nonlinear_poisson.py:369-520).

    ``input_min``/``input_max`` bound the random number of input points
    sampled per call; ``output_sub_level`` is the fraction of output
    queries kept. Boundary points (the first ``num_boundary`` entries of
    the output set) are always preserved.
    """

    def __init__(self, in_normalizer=None, out_normalizer=None,
                 positional_encoding=None, input_min=None, input_max=None,
                 input_sub_level=None, output_sub_level=None,
                 return_dict: bool = True, seed: int = 0):
        self.in_normalizer = in_normalizer
        self.out_normalizer = out_normalizer
        self.positional_encoding = positional_encoding
        self.input_min = input_min
        self.input_max = input_max
        self.input_sub_level = input_sub_level
        self.output_sub_level = output_sub_level or 1.0
        self.return_dict = return_dict
        self._rng = np.random.default_rng(seed)

    def wrap(self, model):
        self.model = model
        return self

    def _subsample_inputs(self, sample):
        x = np.asarray(sample["x"])
        geom = np.asarray(sample["input_geom"])
        n = geom.shape[-2]
        if self.input_sub_level is not None:
            keep = int(n * float(self.input_sub_level))
        elif self.input_min is not None and self.input_max is not None:
            keep = int(self._rng.integers(self.input_min,
                                          min(self.input_max, n) + 1))
        else:
            return sample
        idx = np.sort(self._rng.choice(n, size=max(keep, 1), replace=False))
        sample["x"] = x[..., idx, :]
        sample["input_geom"] = geom[..., idx, :]
        return sample

    def _subsample_outputs(self, sample):
        frac = float(self.output_sub_level)
        if frac >= 1.0:
            return sample
        queries = np.asarray(sample["output_queries"])
        y = np.asarray(sample["y"])
        n = queries.shape[-2]
        n_bound = int(sample.get("num_boundary", 0))
        interior = np.arange(n_bound, n)
        keep = max(int(len(interior) * frac), 1)
        idx = np.concatenate([
            np.arange(n_bound),
            np.sort(self._rng.choice(interior, size=keep, replace=False)),
        ])
        sample["output_queries"] = queries[..., idx, :]
        sample["y"] = y[..., idx, :] if y.ndim >= 2 else y[idx]
        if "output_source_terms_domain" in sample:
            st = np.asarray(sample["output_source_terms_domain"])
            sub = idx[idx >= n_bound] - n_bound
            sample["output_source_terms_domain"] = st[..., sub]
        return sample

    def preprocess(self, sample: dict, train: bool = True) -> dict:
        sample = dict(sample)
        if train:
            sample = self._subsample_inputs(sample)
            sample = self._subsample_outputs(sample)
        if self.in_normalizer is not None:
            sample["x"] = self.in_normalizer.transform(sample["x"])
        if self.out_normalizer is not None and train:
            sample["y"] = self.out_normalizer.transform(sample["y"])
        return sample

    def postprocess(self, out, sample: dict, train: bool = True):
        if self.out_normalizer is not None and not train:
            out = self.out_normalizer.inverse_transform(out)
        return out, sample


def load_nonlinear_poisson_pt(
    data_path: Optional[str] = None,
    query_res: int = 48,
    domain_padding: int = 0,
    val_on_same_instance: bool = False,
    n_train: int = 1,
    n_test: int = 1,
    input_min_sample_points=None,
    input_max_sample_points=None,
    input_subsample_level=None,
    output_subsample_level=None,
    return_dict: bool = True,
    **kwargs,
):
    """Build poisson loaders + processor (reference
    nonlinear_poisson.py:322-366). Returns
    (train_loader, test_loader, data_processor)."""
    from .tensor_dataset import DataLoader

    dataset = NonlinearPoissonDataset(
        file_path=data_path, n_train=n_train, n_test=n_test
    )
    if val_on_same_instance:
        train_loader = test_loader = DataLoader(dataset.train_data, 1)
    else:
        train_loader = DataLoader(dataset.train_data, 1)
        test_loader = DataLoader(dataset.test_data, 1)
    data_processor = PoissonGINODataProcessor(
        input_min=input_min_sample_points,
        input_max=input_max_sample_points,
        input_sub_level=input_subsample_level,
        output_sub_level=output_subsample_level,
        return_dict=return_dict,
    )
    return train_loader, test_loader, data_processor
