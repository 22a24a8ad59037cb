"""Point-axis model parallelism for the GNO family (port of
``neuraloperator_tpu/parallel/distributed_gno.py``).

The JAX functions place a point set, or a padded neighbourhood, with its
point (or query) axis sharded over the mesh's 'model' axis; each device
keeps its slice. A process here is one rank, so each function returns this
model rank's slice: the points it evaluates, and their neighbourhoods
(which index the replicated source points, so the gathers stay local).
"""

from typing import Dict, Optional

import torch

from .mesh import MODEL_AXIS

__all__ = ["point_sharding", "shard_gino_inputs", "shard_neighbors", "shard_points"]


def point_sharding(mesh, ndim: int, point_axis: int, axis_name: str = MODEL_AXIS) -> tuple:
    """The layout that splits ``point_axis`` over the model axis, as the JAX
    ``PartitionSpec`` names it: ``axis_name`` at that dim, None elsewhere."""
    spec = [None] * ndim
    spec[point_axis % ndim] = axis_name
    return tuple(spec)


def _check_divisible(n: int, parts: int, what: str) -> None:
    if n % parts:
        raise ValueError(
            f"{what} has {n} points, not divisible by the '{MODEL_AXIS}' axis size {parts}; "
            "pad the point set (masked points are free) or choose a divisible count")


def _own(t, axis: int, mesh, what: str, axis_name: str = MODEL_AXIS) -> torch.Tensor:
    t = torch.as_tensor(t)
    axis = axis % t.ndim
    parts = mesh.shape[axis_name]
    _check_divisible(t.shape[axis], parts, what)
    chunk = t.shape[axis] // parts
    return t.narrow(axis, mesh.model_rank * chunk, chunk)


def shard_points(points, mesh, point_axis: int = -2, axis_name: str = MODEL_AXIS):
    """This model rank's slice of a point array (..., n_pts, d) along
    ``point_axis`` (-2 by default, the GNO layout (batch, n_pts, channel))."""
    return _own(points, point_axis, mesh, "point array", axis_name)


def shard_neighbors(neighbors: Dict, mesh, axis_name: str = MODEL_AXIS) -> Dict:
    """This model rank's queries of a padded neighbourhood (dim 0 of its
    (m, k) index, mask and norm arrays); a CSR one is made padded first."""
    if "neighbors_row_splits" in neighbors:
        from ..layers.neighbor_search import csr_to_padded

        neighbors = csr_to_padded(neighbors)
    m = torch.as_tensor(neighbors["neighbors_index"]).shape[0]
    _check_divisible(m, mesh.shape[axis_name], "neighborhood query axis")
    return {k: _own(v, 0, mesh, "neighborhood query axis", axis_name)
            for k, v in neighbors.items()}


def shard_gino_inputs(mesh, latent_queries=None, output_queries=None,
                      in_neighbors: Optional[Dict] = None, out_neighbors: Optional[Dict] = None,
                      axis_name: str = MODEL_AXIS):
    """This model rank's part of a GINO call's geometry: the latent queries
    (1, n1..nk, d) cut along their first grid axis, the output queries (or
    each set of a dict) along their point axis, and the padded
    neighbourhoods along their query axis; None passes through."""
    out = [None if latent_queries is None
           else _own(latent_queries, 1, mesh, "latent grid", axis_name)]
    if output_queries is None:
        out.append(None)
    elif isinstance(output_queries, dict):
        out.append({k: shard_points(v, mesh, -2, axis_name) for k, v in output_queries.items()})
    else:
        out.append(shard_points(output_queries, mesh, -2, axis_name))
    for nbrs in (in_neighbors, out_neighbors):
        if nbrs is None:
            out.append(None)
        elif "neighbors_index" not in nbrs and "neighbors_row_splits" not in nbrs:
            out.append({k: shard_neighbors(v, mesh, axis_name) for k, v in nbrs.items()})
        else:
            out.append(shard_neighbors(nbrs, mesh, axis_name))
    return tuple(out)
