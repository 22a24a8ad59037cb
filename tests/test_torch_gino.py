"""GINO and FNOGNO of the PyTorch port against the JAX package, on the CPU.

Each case builds the JAX model, converts its initial parameters into the
port's model (``convert.convert_flax_params``: the flax paths are the
port's names) and feeds both the same numpy inputs and the same
neighbourhoods, JAX's padded search's output: with radius search, the f32
expanded distances round differently in XLA and in torch, and a query may
swap its k-th neighbour at a near tie (tests/test_torch_gno.py holds the
searches as sets). Sizes are tiny: latent grids of 6³ and 8², hidden 8,
modes 4, 2 layers, 96-128 points, 8 neighbours.

Bounds: outputs within 1e-5 relative l2 and parameter gradients (of a
fixed weighted sum of the outputs) within 1e-4, leaf by leaf, each leaf's
error against the larger of its norm and 1% of the whole gradient's (as
``chip_smoke.py`` holds card against CPU): a bias that a normalization
follows (AdaIN's instance norm) has a gradient that is zero but for f32
rounding, in JAX as in the port, and a leaf summed over every point cancels
(the AdaIN case's ``lifting.b1`` lies 1.6e-4 of its own norm from JAX's
float64 gradient, JAX's f32 one 1.2e-5, the leaf 0.3% of the total).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.layers.neighbor_search import padded_neighbor_search as jsearch
from neuraloperator_tpu.models import FNOGNO as JFNOGNO
from neuraloperator_tpu.models import GINO as JGINO
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.models import FNOGNO, GINO, get_model

torch.set_num_threads(1)

TOL, GRAD_TOL = 1e-5, 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def grad_errors(got: dict, want: dict) -> dict:
    """Per-leaf l2 error against the larger of the leaf's norm and 1% of the
    whole gradient's."""
    total = sum(float(np.square(np.asarray(w, np.float64)).sum()) for w in want.values()) ** 0.5
    return {n: float(np.linalg.norm(np.asarray(got[n], np.float64) - np.asarray(w, np.float64))
                     / max(np.linalg.norm(np.asarray(w, np.float64)), 1e-2 * total))
            for n, w in want.items()}


def grid(n: int, dim: int) -> np.ndarray:
    axes = [np.linspace(0, 1, n)] * dim
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).astype(np.float32)


def search(data, queries, radius, k, norm=False):
    """JAX's padded search, as numpy arrays."""
    return {key: np.asarray(v) for key, v in jsearch(jnp.asarray(data), jnp.asarray(queries),
                                                      radius, k, return_norm=norm).items()}


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.array(tree)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return None if tree is None else jnp.asarray(tree)


def gino_case(name):
    """(model kwargs, call kwargs) of a GINO case, numpy inputs."""
    rng = np.random.default_rng({"3d_dict": 0, "2d_options": 1, "ada_in": 2}[name])
    dim = 3 if name == "3d_dict" else 2
    n_pts, r, k = 128 if dim == 3 else 96, 0.35, 8
    kw = dict(in_channels=2, out_channels=2, fno_in_channels=2, gno_coord_dim=dim,
              in_gno_radius=r, out_gno_radius=r, fno_n_modes=(4,) * dim, fno_hidden_channels=8,
              fno_n_layers=2, gno_max_neighbors=k, gno_embed_channels=4,
              in_gno_channel_mlp_hidden_layers=(16, 16), out_gno_channel_mlp_hidden_layers=(16,),
              projection_channel_ratio=2)
    lq = grid(6 if dim == 3 else 8, dim)
    geom = rng.uniform(0, 1, (1, n_pts, dim)).astype(np.float32)
    batch = 2 if name == "2d_options" else 1
    x = rng.standard_normal((batch, n_pts, 2)).astype(np.float32)
    lq_flat = lq.reshape(-1, dim)
    call = dict(input_geom=geom, latent_queries=lq[None], x=x,
                in_neighbors=search(geom[0], lq_flat, r, k))
    if name == "3d_dict":
        probe = rng.uniform(0, 1, (20, dim)).astype(np.float32)
        call["output_queries"] = {"surface": geom[0], "probe": probe}
        call["out_neighbors"] = {"surface": search(lq_flat, geom[0], r, k),
                                 "probe": search(lq_flat, probe, r, k)}
    else:
        call["output_queries"] = geom[0]
        call["out_neighbors"] = search(lq_flat, geom[0], r, k, norm=name == "2d_options")
    if name == "2d_options":
        kw.update(in_gno_transform_type="nonlinear", latent_feature_channels=3,
                  out_gno_tanh="both", gno_weighting_function="bump",
                  gno_weight_function_scale=0.5, in_gno_pos_embed_type="nerf")
        call["latent_features"] = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    if name == "ada_in":
        kw.update(fno_norm="ada_in", fno_ada_in_features=3)
        call["ada_in"] = np.asarray([0.7], np.float32)
    return kw, call


def fnogno_case(name):
    rng = np.random.default_rng({"2d_batched": 3, "3d_unbatched": 4}[name])
    dim = 2 if name == "2d_batched" else 3
    n = 8 if dim == 2 else 6
    in_p = grid(n, dim)
    out_p = rng.uniform(0, 1, (64, dim)).astype(np.float32)
    f_shape = (2, *in_p.shape[:-1], 1) if name == "2d_batched" else (*in_p.shape[:-1], 1)
    f = rng.standard_normal(f_shape).astype(np.float32)
    kw = dict(in_channels=1, out_channels=2, gno_coord_dim=dim, gno_radius=0.35,
              fno_n_modes=(4,) * dim, fno_hidden_channels=8, fno_n_layers=2,
              gno_max_neighbors=8, gno_embed_channels=4, gno_channel_mlp_hidden_layers=(16,),
              projection_channel_ratio=2)
    call = dict(in_p=in_p, out_p=out_p, f=f,
                neighbors=search(in_p.reshape(-1, dim), out_p, 0.35, 8))
    return kw, call


CASES = {**{f"gino_{n}": ("gino", n) for n in ("3d_dict", "2d_options", "ada_in")},
         **{f"fnogno_{n}": ("fnogno", n) for n in ("2d_batched", "3d_unbatched")}}


def _leaves(out):
    return [out[k] for k in sorted(out)] if isinstance(out, dict) else [out]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """The JAX model's parameters, outputs and parameter gradients, and the
    port's model holding those parameters."""
    family, name = CASES[request.param]
    kw, call = (gino_case if family == "gino" else fnogno_case)(name)
    jcls, tcls = (JGINO, GINO) if family == "gino" else (JFNOGNO, FNOGNO)
    jmodel = jcls(**kw)
    jcall = to_jax(call)
    params = jax.jit(lambda key: jmodel.init(key, **jcall))(jax.random.PRNGKey(0))["params"]
    apply = jax.jit(lambda p: jmodel.apply({"params": p}, **jcall))
    outs = [np.asarray(o) for o in _leaves(apply(params))]
    weights = [np.random.default_rng(9).standard_normal(o.shape).astype(np.float32)
               for o in outs]

    def loss(p):
        return sum((o * w).sum() for o, w in zip(_leaves(jmodel.apply({"params": p}, **jcall)),
                                                  weights))

    grads = convert.flatten_flax(jax.jit(jax.grad(loss))(params))
    model = tcls(**kw, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return {"name": request.param, "model": model, "call": to_torch(call), "outs": outs,
            "weights": weights, "grads": grads}


def test_forward_matches_jax(case):
    outs = _leaves(case["model"](**case["call"]))
    assert len(outs) == len(case["outs"])
    for got, want in zip(outs, case["outs"]):
        assert tuple(got.shape) == want.shape
        assert rel(got.detach(), want) < TOL, case["name"]


def test_parameter_gradients_match_jax(case):
    model = case["model"]
    model.zero_grad(set_to_none=True)
    outs = _leaves(model(**case["call"]))
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, case["weights"])).backward()
    got = {name: p.grad.numpy() for name, p in model.named_parameters()}
    assert set(got) == set(case["grads"])
    errs = grad_errors(got, case["grads"])
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_TOL, (case["name"], worst, errs[worst])


def test_gino_searches_inside_the_call_like_jax():
    """Without neighbourhoods each GNO searches inside the call; on these
    points no near tie moves a neighbour, so the output is JAX's."""
    kw, call = gino_case("ada_in")
    jmodel = JGINO(**kw)
    for key in ("in_neighbors", "out_neighbors"):
        call.pop(key)
    jcall = to_jax(call)
    params = jax.jit(lambda key: jmodel.init(key, **jcall))(jax.random.PRNGKey(1))["params"]
    model = GINO(**kw, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    want = np.asarray(jax.jit(lambda p: jmodel.apply({"params": p}, **jcall))(params))
    assert rel(model(**to_torch(call)).detach(), want) < TOL


def test_get_model_builds_the_gno_models():
    gino = get_model({"model_arch": "GINO", "in_channels": 1, "out_channels": 1,
                      "fno_n_modes": [4, 4], "gno_coord_dim": 2, "fno_hidden_channels": 8,
                      "fno_n_layers": 1}, device="cpu")
    fnogno = get_model({"model_arch": "fnogno", "in_channels": 1, "out_channels": 1,
                        "fno_n_modes": [4, 4], "gno_coord_dim": 2, "fno_hidden_channels": 8,
                        "fno_n_layers": 1}, device="cpu")
    assert isinstance(gino, GINO) and isinstance(fnogno, FNOGNO)
    assert {"gno_in", "lifting", "fno_blocks", "gno_out", "projection"} <= {
        n for n, _ in gino.named_children()}
    assert {"lifting", "fno_blocks", "gno", "projection"} <= {
        n for n, _ in fnogno.named_children()}
