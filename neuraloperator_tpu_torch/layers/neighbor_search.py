"""Fixed-radius neighbour search (port of
``neuraloperator_tpu/layers/neighbor_search.py``).

* :func:`padded_neighbor_search` -- the search on every model path: the
  (m, n) squared distances in the expanded form ``|q|² + |p|² - 2 q·p``
  (one matmul, TF32 off), masked by the radius, the ``max_neighbors``
  nearest kept by ``torch.topk``; a padded ``(m, k)`` index list and mask.
* :func:`native_neighbor_search` -- the host search in the reference's CSR
  layout: the C++ grid hash of ``csrc/neighbor_search.cpp`` (built by g++ at
  first use; a failed build raises) for 1-3 dims, the numpy search
  :func:`fixed_radius_search_numpy` (its plain version) above 3 dims.
* :func:`csr_to_padded` -- the CSR layout to the padded one.

Near ties: the distances are f32 sums whose rounding depends on the order
of the dot product's terms, so where a query's k-th and (k+1)-th distances
lie within a few ulps of each other the kept set may differ from the JAX
package's by that one neighbour; slots past the radius hold arbitrary
indices in both packages.
"""

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from .._native import load_host_library
from ..ops.fourier import dft_matmul_precision

_lib: Optional[ctypes.CDLL] = None


def _search_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_host_library("neighbor_search")
        fn = lib.fixed_radius_search
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
    return _lib


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def fixed_radius_search_cpp(data, queries, radius: float):
    """``(neighbors_index, neighbors_row_splits)``, int64 numpy arrays, by the
    C++ grid hash (1-3 dims; ascending indices within each query)."""
    data = np.ascontiguousarray(_host_array(data), dtype=np.float32)
    queries = np.ascontiguousarray(_host_array(queries), dtype=np.float32)
    if data.ndim != 2 or queries.ndim != 2 or data.shape[1] != queries.shape[1]:
        raise ValueError(
            f"expected (n,d)/(m,d) point arrays, got {data.shape} and {queries.shape}")
    dim = data.shape[1]
    if not 1 <= dim <= 3:
        raise ValueError(f"the C++ search takes 1-3 dims, got {dim}")
    lib = _search_lib()
    n, m = data.shape[0], queries.shape[0]
    row_splits = np.zeros(m + 1, dtype=np.int64)
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int64)
    d_p = data.ctypes.data_as(fptr)
    q_p = queries.ctypes.data_as(fptr)
    rs_p = row_splits.ctypes.data_as(iptr)
    total = lib.fixed_radius_search(d_p, n, q_p, m, dim, radius, 0, rs_p, None)
    if total < 0:
        raise RuntimeError(f"the C++ search refused {n} points and {m} queries in {dim} dims")
    indices = np.empty(max(int(total), 1), dtype=np.int64)
    lib.fixed_radius_search(d_p, n, q_p, m, dim, radius, 1, rs_p,
                            indices.ctypes.data_as(iptr))
    return indices[: int(total)], row_splits


def fixed_radius_search_numpy(data, queries, radius: float):
    """The plain version of the search: every distance, O(n·m); also the
    ``neighbors_norm`` of each kept pair. Returns (index, row_splits, norms)."""
    data, queries = _host_array(data), _host_array(queries)
    d2 = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    within = d2 <= radius ** 2
    counts = within.sum(axis=1)
    splits = np.zeros(len(queries) + 1, dtype=np.int64)
    np.cumsum(counts, out=splits[1:])
    index = np.nonzero(within)[1].astype(np.int64)
    return index, splits, d2[within]


def native_neighbor_search(data, queries, radius: float,
                           return_norm: bool = False) -> Dict[str, torch.Tensor]:
    """Host search -> CSR dict of CPU tensors: ``neighbors_index``,
    ``neighbors_row_splits`` and, with ``return_norm``, ``neighbors_norm``
    (squared distances). The C++ search for 1-3 dims, the numpy one above."""
    data, queries = _host_array(data), _host_array(queries)
    if data.ndim == 2 and queries.ndim == 2 and data.shape[-1] <= 3:
        index, splits = fixed_radius_search_cpp(data, queries, radius)
        out = {"neighbors_index": index, "neighbors_row_splits": splits}
        if return_norm:
            counts = splits[1:] - splits[:-1]
            query_of = np.repeat(np.arange(len(queries), dtype=np.int64), counts)
            diff = queries[query_of] - data[index]
            out["neighbors_norm"] = (diff ** 2).sum(-1)
    else:
        index, splits, norms = fixed_radius_search_numpy(data, queries, radius)
        out = {"neighbors_index": index, "neighbors_row_splits": splits}
        if return_norm:
            out["neighbors_norm"] = norms
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def csr_to_padded(neighbors: Dict, max_neighbors: Optional[int] = None) -> Dict:
    """CSR dict -> padded ``neighbors_index`` (m, k) and ``neighbors_mask``
    (m, k) (and ``neighbors_norm`` (m, k) when given), with k the largest
    degree unless ``max_neighbors`` caps it; on the index's device."""
    index_t = torch.as_tensor(neighbors["neighbors_index"])
    device = index_t.device
    index = _host_array(index_t)
    splits = _host_array(neighbors["neighbors_row_splits"])
    counts = splits[1:] - splits[:-1]
    m = len(counts)
    k = int(max_neighbors if max_neighbors is not None else max(counts.max(), 1))
    keep = np.minimum(counts, k)
    rows = np.repeat(np.arange(m), keep)
    cols = np.arange(len(rows)) - np.repeat(np.cumsum(keep) - keep, keep)
    src = np.repeat(splits[:-1], keep) + cols
    padded = np.zeros((m, k), dtype=np.int64)
    mask = np.zeros((m, k), dtype=bool)
    padded[rows, cols] = index[src]
    mask[rows, cols] = True
    out = {"neighbors_index": torch.from_numpy(padded).to(device),
           "neighbors_mask": torch.from_numpy(mask).to(device)}
    if "neighbors_norm" in neighbors:
        norm = np.zeros((m, k), dtype=np.float32)
        norm[rows, cols] = _host_array(neighbors["neighbors_norm"])[src]
        out["neighbors_norm"] = torch.from_numpy(norm).to(device)
    return out


def padded_neighbor_search(
    data: torch.Tensor,
    queries: torch.Tensor,
    radius: float,
    max_neighbors: int,
    return_norm: bool = False,
) -> Dict[str, torch.Tensor]:
    """The ``max_neighbors`` nearest points of ``data`` (n, d) within
    ``radius`` of each query (m, d), nearest first: ``neighbors_index``
    (m, k), ``neighbors_mask`` (m, k) and, with ``return_norm``,
    ``neighbors_norm`` (m, k), the squared distances (0 where masked).

    The cross term ``q·p`` runs with TF32 off whatever ``training.setup``
    chose (a TF32 product errs by about 1e-3·|q|², which would move points
    across the radius); only the norms carry a gradient."""
    qn = (queries ** 2).sum(dim=-1, keepdim=True)
    pn = (data ** 2).sum(dim=-1)[None, :]
    with dft_matmul_precision():
        cross = queries @ data.T
    d2 = torch.clamp(qn + pn - 2.0 * cross, min=0.0)
    within = d2 <= radius ** 2
    ranked = torch.where(within, d2, torch.full_like(d2, float("inf")))
    values, idx = torch.topk(ranked, max_neighbors, dim=-1, largest=False, sorted=True)
    mask = torch.isfinite(values)
    out = {"neighbors_index": idx, "neighbors_mask": mask}
    if return_norm:
        out["neighbors_norm"] = torch.where(mask, values, torch.zeros_like(values))
    return out


class NeighborSearch:
    """The reference module's interface. ``mode="padded"`` (the default)
    returns the padded layout: :func:`padded_neighbor_search` with
    ``max_neighbors``, else the host search padded to the largest degree;
    ``mode="csr"`` returns the host search's CSR dict."""

    def __init__(self, return_norm: bool = False, mode: str = "padded",
                 max_neighbors: Optional[int] = None):
        self.return_norm = return_norm
        self.mode = mode
        self.max_neighbors = max_neighbors

    def __call__(self, data, queries, radius: float) -> Dict:
        if self.mode == "csr":
            return native_neighbor_search(data, queries, radius, return_norm=self.return_norm)
        if self.max_neighbors is not None:
            return padded_neighbor_search(torch.as_tensor(data), torch.as_tensor(queries),
                                          radius, self.max_neighbors,
                                          return_norm=self.return_norm)
        # no budget: the host search, padded to the largest degree
        return csr_to_padded(native_neighbor_search(data, queries, radius,
                                                    return_norm=self.return_norm))
