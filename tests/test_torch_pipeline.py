"""GPipe over the model ranks and data-parallel serving at gloo world size 4
on the CPU, against the JAX package on its 8 fake CPU devices (the cases of
``tests/test_pipeline.py`` and ``tests/test_serving.py``'s mesh case).

The JAX tests run 2 data x 4 stages over 8 devices; the port's group of 4
runs 1 x 4 stages, and the pipeline with ZeRO on 2 data x 2 stages.
Tolerances are JAX's own: the toy schedule at ``rtol=1e-6``, the pipelined
forward at ``atol=2e-5``, its gradients at ``atol=3e-5``, the pipelined
ZeRO steps at ``atol=2e-4`` (loss ``rtol=1e-5``), the served answers at
``rtol=1e-5, atol=1e-6``. One group of spawned ranks runs every case; the
JAX side runs in the test process.
"""

import numpy as np
import pytest
import torch

from neuraloperator_tpu_torch.parallel import mesh as mesh_lib
from neuraloperator_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

WORLD = 4
SCAN_KW = dict(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=8, n_layers=4,
               scan_layers=True)
SERVE_KW = dict(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=8, n_layers=2)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _leaves(params):
    from neuraloperator_tpu_torch import convert

    return convert.flatten_flax(_numpy_tree(params))


def _fno(kwargs, params):
    from neuraloperator_tpu_torch import convert
    from neuraloperator_tpu_torch.models import FNO

    model = FNO(**kwargs, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return model


# --------------------------------------------------------------------------- the ranks


def _case_gpipe(rank, inputs):
    from neuraloperator_tpu_torch.parallel.pipeline import gpipe

    mesh = mesh_lib.init(model_parallel_size=WORLD, device="cpu")
    weights = torch.tensor([2.0, 3.0, 5.0, 7.0])
    x_mb = torch.from_numpy(inputs["x_mb"]).requires_grad_()
    w = weights[mesh.model_rank:mesh.model_rank + 1].clone().requires_grad_()
    y = gpipe(lambda w, x: x * w[0], w, x_mb, n_stages=WORLD)
    y.sum().backward()
    return {"y": y.detach().numpy(), "x_grad": x_mb.grad.numpy(), "w_grad": float(w.grad)}


def _case_pipelined_fno(rank, inputs):
    from neuraloperator_tpu_torch.parallel.pipeline import pipelined_fno_forward

    mesh = mesh_lib.init(model_parallel_size=WORLD, device="cpu")
    model = _fno(SCAN_KW, inputs["params"])
    x, y = (torch.from_numpy(a) for a in (inputs["x"], inputs["y"]))
    out = pipelined_fno_forward(model, x, mesh, n_microbatches=4)
    torch.mean((out - y) ** 2).backward()
    return {"out": out.detach().numpy(),
            "grads": {n: p.grad.numpy().copy() for n, p in model.named_parameters()}}


def _case_pipeline_zero(rank, inputs):
    """2 data x 2 stages: two AdamW steps of the pipelined forward, the
    gradients averaged over the data ranks, the state cut by ZeRO."""
    from neuraloperator_tpu_torch.parallel import comm
    from neuraloperator_tpu_torch.parallel.pipeline import pipelined_fno_forward
    from neuraloperator_tpu_torch.parallel.zero import ZeroAdamW
    from neuraloperator_tpu_torch.training import adamw

    mesh = mesh_lib.init(model_parallel_size=2, device="cpu")
    model = _fno(SCAN_KW, inputs["params"])
    opt = ZeroAdamW(adamw(1e-3, weight_decay=1e-4), model.named_parameters(), mesh)
    batch = mesh_lib.shard_batch({"x": inputs["x"], "y": inputs["y2"]}, mesh)
    for _ in range(2):
        opt.zero_grad()
        out = pipelined_fno_forward(model, batch["x"], mesh, n_microbatches=2)
        loss = torch.mean((out - batch["y"]) ** 2)
        loss.backward()
        comm.reduce_gradients(list(model.parameters()), mesh.data_group, "mean")
        loss = comm.reduce_value(loss.detach(), mesh.data_group, "mean")
        opt.step()
    cut = [2 * loc.numel() == p.numel() for (_, p), d, loc in zip(opt.params, opt.dims,
                                                                  opt.local) if d is not None]
    return {"loss": float(loss), "cut": cut,
            "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()}}


def _case_serve(rank, inputs):
    from neuraloperator_tpu_torch.serving import CompiledForward

    mesh = mesh_lib.init(model_parallel_size=1, device="cpu")
    model = _fno(SERVE_KW, inputs["serve_params"])
    x = torch.from_numpy(inputs["serve_x"])
    served = CompiledForward(model, x, batch_sizes=(8,), mesh=mesh, device="cpu")
    return {"out": served(torch.cat([x, x])).numpy(), "three": served(x[:3]).numpy()}


CASES = ["gpipe", "pipelined_fno", "pipeline_zero", "serve"]


def _ranks_main(rank, world, inputs):
    return {name: globals()[f"_case_{name}"](rank, inputs) for name in CASES}


# ------------------------------------------------------------------------ the JAX side


@pytest.fixture(scope="module")
def inputs():
    import jax

    from neuraloperator_tpu.models import FNO as JFNO

    x = jax.random.normal(jax.random.PRNGKey(0), (8, 1, 8, 8))
    params = JFNO(**SCAN_KW).init(jax.random.PRNGKey(1), x)["params"]
    sx = jax.random.normal(jax.random.PRNGKey(5), (4, 1, 8, 8))
    serve_params = JFNO(**SERVE_KW).init(jax.random.PRNGKey(6), sx)["params"]
    return {"x_mb": np.random.RandomState(0).randn(6, 2, 3).astype(np.float32),
            "x": np.asarray(x), "params": _numpy_tree(params),
            "y": np.asarray(jax.random.normal(jax.random.PRNGKey(2), (8, 1, 8, 8))),
            "y2": np.asarray(jax.random.normal(jax.random.PRNGKey(3), (8, 1, 8, 8))),
            "serve_x": np.asarray(sx), "serve_params": _numpy_tree(serve_params)}


@pytest.fixture(scope="module")
def world(inputs):
    return run_ranks(_ranks_main, WORLD, (inputs,), timeout_s=300)


def test_gpipe_schedule_matches_sequential(world, inputs):
    """A toy 4-stage pipeline (y = x * w0*w1*w2*w3) against JAX's schedule;
    the gradients of the reversed schedule: each x by the product, each
    stage's weight by the others' product times the sum of x."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.pipeline import gpipe

    mesh = jmesh.init(model_parallel_size=4)
    weights = jnp.asarray([2.0, 3.0, 5.0, 7.0])
    fn = jax.shard_map(lambda w, xmb: gpipe(lambda w, x: x * w[0], w, xmb, n_stages=4),
                       mesh=mesh, in_specs=(P("model"), P(None, "data")),
                       out_specs=P(None, "data"), check_vma=False)
    want = np.asarray(jax.jit(fn)(weights, inputs["x_mb"]))
    np.testing.assert_allclose(want, inputs["x_mb"] * 210.0, rtol=1e-6)
    for rank, got in enumerate(world):
        got = got["gpipe"]
        np.testing.assert_allclose(got["y"], want, rtol=1e-6)
        np.testing.assert_allclose(got["x_grad"], np.full_like(inputs["x_mb"], 210.0),
                                   rtol=1e-6)
        np.testing.assert_allclose(got["w_grad"], 210.0 / [2, 3, 5, 7][rank]
                                   * inputs["x_mb"].sum(), rtol=1e-5)


def _jax_local(inputs):
    import jax
    import jax.numpy as jnp

    from neuraloperator_tpu.models import FNO as JFNO

    model = JFNO(**SCAN_KW)
    out = model.apply({"params": inputs["params"]}, inputs["x"])
    grads = jax.grad(lambda p: jnp.mean((model.apply({"params": p}, inputs["x"])
                                         - inputs["y"]) ** 2))(inputs["params"])
    return np.asarray(out), _leaves(grads)


def test_pipelined_fno_forward_matches_local(world, inputs):
    want, _ = _jax_local(inputs)
    for got in world:
        np.testing.assert_allclose(got["pipelined_fno"]["out"], want, atol=2e-5)


def test_pipelined_fno_grads_match_local(world, inputs):
    _, grads = _jax_local(inputs)
    for got in world:
        got = got["pipelined_fno"]["grads"]
        assert set(got) == set(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(got[name], g, atol=3e-5, err_msg=name)


def test_pipelined_fno_validates_config():
    from types import SimpleNamespace

    from neuraloperator_tpu_torch.models import FNO
    from neuraloperator_tpu_torch.parallel.pipeline import gpipe, pipelined_fno_forward

    mesh = SimpleNamespace(shape={"data": 2, "model": 4})
    x = torch.zeros(4, 1, 8, 8)
    three = FNO(**dict(SCAN_KW, n_layers=3), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        pipelined_fno_forward(three, x, mesh, n_microbatches=2)
    unrolled = FNO(**dict(SCAN_KW, scan_layers=False), device="cpu")
    with pytest.raises(ValueError, match="scan_layers"):
        pipelined_fno_forward(unrolled, x, mesh, n_microbatches=2)
    four = FNO(**SCAN_KW, device="cpu")
    with pytest.raises(ValueError, match="n_microbatches"):
        pipelined_fno_forward(four, x, mesh, n_microbatches=3)
    with pytest.raises(ValueError, match="model group of 4"):
        gpipe(lambda w, x: x, None, x[None], n_stages=4)


def test_pipeline_with_zero_train_step(world, inputs):
    """2 data x 2 stages x ZeRO: two steps of the pipelined forward against
    JAX's two single-device optax steps."""
    import jax
    import jax.numpy as jnp
    import optax

    from neuraloperator_tpu.models import FNO as JFNO

    model, opt = JFNO(**SCAN_KW), optax.adamw(1e-3)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    state = opt.init(params)
    for _ in range(2):
        loss, g = jax.value_and_grad(lambda p: jnp.mean(
            (model.apply({"params": p}, inputs["x"]) - inputs["y2"]) ** 2))(params)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    want = _leaves(params)
    for got in world:
        got = got["pipeline_zero"]
        assert got["cut"] and all(got["cut"])
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(got["params"][name], w, atol=2e-4, err_msg=name)


def test_compiled_forward_multi_device_dp(world, inputs):
    """mesh= serves data-parallel: each rank answers its quarter of the
    bucket and the answers are gathered; against JAX's mesh endpoint."""
    import jax.numpy as jnp

    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.serving import CompiledForward as JCompiled

    x = jnp.asarray(inputs["serve_x"])
    jm = jmesh.init()
    served = JCompiled(JFNO(**SERVE_KW), inputs["serve_params"], x, batch_sizes=(8,), mesh=jm)
    want = np.asarray(served(jnp.concatenate([x, x], axis=0)))
    for got in world:
        np.testing.assert_allclose(got["serve"]["out"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["serve"]["three"], want[:3], rtol=1e-5, atol=1e-6)
