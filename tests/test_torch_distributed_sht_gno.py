"""The latitude-sharded spherical convolution and the point-axis slices of
the GNO family at gloo world size 4 on the CPU, against the JAX package on
its 8 fake CPU devices (the cases of ``tests/test_distributed_sht.py`` and
the point-sharded cases of ``tests/test_mesh.py``).

Tolerances are JAX's own: the spherical forwards at ``rtol=2e-4,
atol=2e-4``, the weight gradient at 2e-3 / 2e-3; the point-sharded GINO
output at 2e-3 / 1e-4. JAX's SFNO case only finds its sharded forward and
gradients finite; the port's are held to JAX's at the forward bound and
the gradient bound. One group of spawned ranks runs every case; the JAX
side runs in the test process.
"""

import numpy as np
import pytest
import torch

from neuraloperator_tpu_torch.parallel import mesh as mesh_lib
from neuraloperator_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

WORLD = 4
SHT_CASES = [("equiangular", 8, 6), ("equiangular", 12, 9), ("legendre-gauss", 8, 6),
             ("legendre-gauss", 12, 9)]
SFNO_KW = dict(n_modes=(8, 8), in_channels=1, out_channels=1, hidden_channels=8, n_layers=2)
GINO_KW = dict(in_channels=4, out_channels=2, gno_coord_dim=3, in_gno_radius=0.4,
               out_gno_radius=0.4, fno_in_channels=4, fno_n_modes=(4, 4, 4),
               fno_hidden_channels=8, fno_n_layers=1, gno_max_neighbors=16,
               in_gno_channel_mlp_hidden_layers=(16,), out_gno_channel_mlp_hidden_layers=(16,))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _leaves(params):
    from neuraloperator_tpu_torch import convert

    return convert.flatten_flax(_numpy_tree(params))


def _port(cls, kwargs, params):
    from neuraloperator_tpu_torch import convert

    model = cls(**kwargs, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return model


# --------------------------------------------------------------------------- the ranks


def _case_sht(rank, inputs):
    from neuraloperator_tpu_torch.parallel.distributed_sht import distributed_spherical_conv

    mesh = mesh_lib.init(model_parallel_size=WORLD, device="cpu")
    out = {}
    for grid, lmax, mmax in SHT_CASES:
        x, w = inputs["sht"][(grid, lmax, mmax)]
        out[(grid, lmax, mmax)] = distributed_spherical_conv(
            torch.from_numpy(x), torch.from_numpy(w), lmax, mmax, mesh, grid=grid).numpy()
    x, w_st = inputs["sht_grad"]
    w_st = torch.from_numpy(w_st).requires_grad_()
    y = distributed_spherical_conv(torch.from_numpy(x), (w_st[0], w_st[1]), 6, 5, mesh)
    (y * y).sum().backward()
    out["grad"] = w_st.grad.numpy()
    return out


def _case_modules(rank, inputs):
    """The conv module on and off the mesh, and the SFNO built with it."""
    from neuraloperator_tpu_torch.models import SFNO
    from neuraloperator_tpu_torch.parallel.distributed_sht import DistributedSphericalConv

    conv = _port(DistributedSphericalConv, dict(in_channels=3, out_channels=3, n_modes=(8, 12)),
                 inputs["conv_params"])
    x = torch.from_numpy(inputs["conv_x"])
    with mesh_lib.use_mesh(None), torch.no_grad():
        local = conv(x).numpy()
    mesh = mesh_lib.init(model_parallel_size=WORLD, device="cpu")
    with torch.no_grad():
        sharded = conv(x).numpy()
    model = _port(SFNO, dict(SFNO_KW, conv_module=DistributedSphericalConv),
                  inputs["sfno_params"])
    xs = torch.from_numpy(inputs["sfno_x"])
    y = model(xs)
    (y ** 2).sum().backward()
    return {"local": local, "sharded": sharded, "mesh": repr(mesh), "sfno": y.detach().numpy(),
            "sfno_grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()}}


def _case_gno(rank, inputs):
    """Each model rank's slices of a GINO call's geometry; then the GINO
    forward on its output queries and their neighbourhoods, gathered."""
    from neuraloperator_tpu_torch.models import GINO
    from neuraloperator_tpu_torch.parallel import comm
    from neuraloperator_tpu_torch.parallel.distributed_gno import shard_gino_inputs, shard_points

    mesh = mesh_lib.init(model_parallel_size=2, device="cpu")
    g = inputs["gino"]
    lq, oq, inn, onn = shard_gino_inputs(mesh, latent_queries=g["latent_queries"],
                                         output_queries=g["output_queries"],
                                         in_neighbors=g["in_nbrs"], out_neighbors=g["out_nbrs"])
    model = _port(GINO, GINO_KW, g["params"])
    t = {k: torch.from_numpy(v) for k, v in g.items() if isinstance(v, np.ndarray)}
    with torch.no_grad():
        out = model(t["input_geom"], t["latent_queries"], oq, t["x"],
                    in_neighbors={k: torch.as_tensor(v) for k, v in g["in_nbrs"].items()},
                    out_neighbors=onn)
    try:
        shard_points(torch.zeros(1, 15, 3), mesh)
        error = None
    except ValueError as e:
        error = str(e)
    return {"latent": lq.numpy(), "output_queries": oq.numpy(),
            "in_nbrs": {k: v.numpy() for k, v in inn.items()},
            "out_nbrs": {k: v.numpy() for k, v in onn.items()},
            "out": comm.all_gather_along(out, 1, mesh.model_group).numpy(),
            "model_rank": mesh.model_rank, "error": error}


CASES = ["sht", "modules", "gno"]


def _ranks_main(rank, world, inputs):
    return {name: globals()[f"_case_{name}"](rank, inputs) for name in CASES}


# ------------------------------------------------------------------------ the JAX side


@pytest.fixture(scope="module")
def inputs():
    import jax
    import jax.numpy as jnp

    from neuraloperator_tpu.layers.neighbor_search import padded_neighbor_search
    from neuraloperator_tpu.models import GINO as JGINO
    from neuraloperator_tpu.models import SFNO as JSFNO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.distributed_sht import DistributedSphericalConv as JConv

    sht = {}
    for grid, lmax, mmax in SHT_CASES:
        rng = np.random.RandomState(0)
        x = rng.randn(2, 3, 16, 24).astype(np.float32)
        w = (rng.randn(3, 4, lmax) + 1j * rng.randn(3, 4, lmax)).astype(np.complex64)
        sht[(grid, lmax, mmax)] = (x, w)
    rng = np.random.RandomState(1)
    x_g = rng.randn(1, 2, 8, 16).astype(np.float32)
    w_g = rng.randn(2, 2, 3, 6).astype(np.float32)
    conv_x = np.random.RandomState(2).randn(2, 3, 16, 24).astype(np.float32)
    jmesh._CURRENT_MESH = None
    conv_params = JConv(in_channels=3, out_channels=3, n_modes=(8, 12)).init(
        jax.random.PRNGKey(0), conv_x)["params"]
    sfno_x = np.random.RandomState(0).randn(2, 1, 16, 16).astype(np.float32)
    sfno_params = JSFNO(**SFNO_KW, conv_module=JConv).init(jax.random.PRNGKey(0),
                                                           sfno_x)["params"]
    rng = np.random.RandomState(3)
    input_geom = rng.rand(1, 40, 3).astype(np.float32)
    axes = [np.linspace(0, 1, 4, dtype=np.float32)] * 3
    latent_queries = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)[None]
    output_queries = rng.rand(1, 16, 3).astype(np.float32)
    x = rng.rand(2, 40, 4).astype(np.float32)
    lq_flat = jnp.asarray(latent_queries.reshape(-1, 3))
    in_nbrs = _numpy_tree(padded_neighbor_search(jnp.asarray(input_geom[0]), lq_flat, 0.4, 16))
    out_nbrs = _numpy_tree(padded_neighbor_search(lq_flat, jnp.asarray(output_queries[0]), 0.4,
                                                  16))
    gino_params = JGINO(**GINO_KW).init(
        jax.random.PRNGKey(0), input_geom, latent_queries, output_queries, x,
        in_neighbors=in_nbrs, out_neighbors=out_nbrs)["params"]
    return {"sht": sht, "sht_grad": (x_g, w_g), "conv_x": conv_x,
            "conv_params": _numpy_tree(conv_params), "sfno_x": sfno_x,
            "sfno_params": _numpy_tree(sfno_params),
            "gino": {"input_geom": input_geom, "latent_queries": latent_queries,
                     "output_queries": output_queries, "x": x, "in_nbrs": in_nbrs,
                     "out_nbrs": out_nbrs, "params": _numpy_tree(gino_params)}}


@pytest.fixture(scope="module")
def world(inputs):
    return run_ranks(_ranks_main, WORLD, (inputs,), timeout_s=300)


def _jax_local_sht(x, w, lmax, mmax, grid):
    from neuraloperator_tpu.layers.spherical_convolution import contract_dhconv
    from neuraloperator_tpu.ops.sht import isht, sht

    flm = sht(x, lmax=lmax, mmax=mmax, grid=grid)
    return isht(contract_dhconv(flm, w), nlat=x.shape[-2], nlon=x.shape[-1], grid=grid)


@pytest.mark.parametrize("grid,lmax,mmax", SHT_CASES)
def test_distributed_sht_matches_single_device(world, inputs, grid, lmax, mmax):
    """mmax=6 splits unevenly over 4 ranks (padded to 8); mmax=9 to 12."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.distributed_sht import distributed_spherical_conv

    x, w = inputs["sht"][(grid, lmax, mmax)]
    mesh = jmesh.init(model_parallel_size=4)
    with mesh:
        xs = jax.device_put(x, NamedSharding(mesh, P(None, None, "model", None)))
        want = np.asarray(jax.jit(lambda v: distributed_spherical_conv(
            v, w, lmax, mmax, mesh, grid=grid))(xs))
    np.testing.assert_allclose(want, np.asarray(_jax_local_sht(x, w, lmax, mmax, grid)),
                               rtol=2e-4, atol=2e-4)
    for got in world:
        np.testing.assert_allclose(got["sht"][(grid, lmax, mmax)], want, rtol=2e-4, atol=2e-4)


def test_distributed_sht_differentiates(world, inputs):
    import jax
    import jax.numpy as jnp

    x, w_st = inputs["sht_grad"]

    def loss_ref(w_st, x):
        y = _jax_local_sht(x, jax.lax.complex(w_st[0], w_st[1]), 6, 5, "equiangular")
        return jnp.sum(y * y)

    want = np.asarray(jax.grad(loss_ref)(w_st, x))
    for got in world:
        np.testing.assert_allclose(got["sht"]["grad"], want, rtol=2e-3, atol=2e-3)


def test_module_params_run_with_and_without_mesh(world, inputs):
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.distributed_sht import DistributedSphericalConv as JConv

    jmesh._CURRENT_MESH = None
    want = np.asarray(JConv(in_channels=3, out_channels=3, n_modes=(8, 12)).apply(
        {"params": inputs["conv_params"]}, inputs["conv_x"]))
    for got in world:
        got = got["modules"]
        assert "'model': 4" in got["mesh"]
        np.testing.assert_allclose(got["local"], want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got["sharded"], want, rtol=2e-4, atol=2e-4)


def test_module_rejects_unsupported_config():
    from neuraloperator_tpu_torch.parallel.distributed_sht import DistributedSphericalConv

    for kwargs in ({"factorization": "cp"}, {"separable": True}, {"complex_data": True},
                   {"sht_grids": ("equiangular", "legendre-gauss")},
                   {"resolution_scaling_factor": 2}):
        with pytest.raises(ValueError, match="does not support"):
            DistributedSphericalConv(2, 2, (4, 4), device="cpu", **kwargs)
    conv = DistributedSphericalConv(2, 2, (4, 4), device="cpu")
    assert conv.w_weight.shape == (2, 2, 2, 4) and conv.bias.shape == (2, 1, 1)


def test_sfno_with_distributed_conv_module(world, inputs):
    """The SFNO with the latitude-sharded conv on 4 model ranks: its forward
    and every gradient against JAX's local SFNO on the same weights."""
    import jax
    import jax.numpy as jnp

    from neuraloperator_tpu.models import SFNO as JSFNO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.distributed_sht import DistributedSphericalConv as JConv

    jmesh._CURRENT_MESH = None
    model = JSFNO(**SFNO_KW, conv_module=JConv)
    x = inputs["sfno_x"]
    want = np.asarray(model.apply({"params": inputs["sfno_params"]}, x))
    grads = _leaves(jax.grad(lambda p: jnp.sum(model.apply({"params": p}, x) ** 2))(
        inputs["sfno_params"]))
    for got in world:
        got = got["modules"]
        assert got["sfno"].shape == x.shape
        np.testing.assert_allclose(got["sfno"], want, rtol=2e-4, atol=2e-4)
        for name, g in grads.items():
            np.testing.assert_allclose(got["sfno_grads"][name], g, rtol=2e-3, atol=2e-3,
                                       err_msg=name)


def test_gino_point_sharded_matches_single_device(world, inputs):
    """Each model rank's slices of the geometry are the JAX mesh's shards;
    the GINO's outputs over each rank's output queries and their
    neighbourhoods, gathered, are JAX's point-sharded (= single-device)
    outputs. The in-GNO runs on the whole latent grid on every rank: the
    port writes out no gather of latent slices before the FNO, where XLA
    inserts one."""
    import jax
    import jax.numpy as jnp

    from neuraloperator_tpu.models import GINO as JGINO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.distributed_gno import shard_gino_inputs

    g = inputs["gino"]
    mesh = jmesh.init(model_parallel_size=2)
    with mesh:
        shards = shard_gino_inputs(mesh, latent_queries=jnp.asarray(g["latent_queries"]),
                                   output_queries=jnp.asarray(g["output_queries"]),
                                   in_neighbors=g["in_nbrs"], out_neighbors=g["out_nbrs"])
        want = np.asarray(jax.jit(lambda lq, oq, inn, onn: JGINO(**GINO_KW).apply(
            {"params": g["params"]}, jnp.asarray(g["input_geom"]), lq, oq, jnp.asarray(g["x"]),
            in_neighbors=inn,
            out_neighbors=onn))(*shards))

    def shard_of(arr, model_rank):
        """The data of a JAX array's shard at model index ``model_rank`` (device
        i of the mesh sits at (i // 2, i % 2))."""
        return next(np.asarray(s.data) for s in arr.addressable_shards
                    if s.device.id % 2 == model_rank)

    for got in world:
        got = got["gno"]
        m = got["model_rank"]
        np.testing.assert_array_equal(got["latent"], shard_of(shards[0], m))
        np.testing.assert_array_equal(got["output_queries"], shard_of(shards[1], m))
        for k in g["in_nbrs"]:
            np.testing.assert_array_equal(got["in_nbrs"][k], shard_of(shards[2][k], m))
            np.testing.assert_array_equal(got["out_nbrs"][k], shard_of(shards[3][k], m))
        np.testing.assert_allclose(got["out"], want, rtol=2e-3, atol=1e-4)


def test_shard_points_divisibility_error(world):
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.distributed_gno import shard_points as jshard_points

    import jax.numpy as jnp

    with pytest.raises(ValueError, match="not divisible") as jax_error:
        jshard_points(jnp.zeros((1, 15, 3)), jmesh.init(model_parallel_size=2))
    for got in world:
        assert got["gno"]["error"] == str(jax_error.value)
