"""The port's mesh, its collectives and data parallelism through the
``Trainer`` and the scripts, at gloo world sizes 2 and 4 on the CPU,
against the JAX package on its 8 fake CPU devices (the cases of
``tests/test_mesh.py``).

Each world size is one group of spawned ranks (``parallel.launch.run_ranks``)
that runs every case once; the tests read their case's results. The ranks
import nothing of JAX: the JAX side (initial weights, inputs, the reference
results) runs in the test process. Tolerances are JAX's own: forwards at
``rtol=2e-4, atol=1e-5`` (the other families at 5e-4 / 5e-5, GINO at 2e-3 /
1e-4), data-parallel gradients at 2e-4 / 1e-6 (the factorized TFNO's at
5e-4 / 1e-5). A data-parallel step sums its ranks' gradients in another
order than one process sums the global batch's, so the port's step is held
to the single-process step at the same bounds.
"""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from neuraloperator_tpu_torch.parallel import comm
from neuraloperator_tpu_torch.parallel import mesh as mesh_lib
from neuraloperator_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

FNO_KW = dict(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=8, n_layers=2)
TFNO_KW = dict(FNO_KW, factorization="tucker", rank=0.4, implementation="factorized")
FORWARD_TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
FAMILY_TOL = dict(rtol=5e-4, atol=5e-5)
FAMILIES = {
    "uno": ("UNO", dict(in_channels=2, out_channels=1, hidden_channels=16, lifting_channels=32,
                        projection_channels=32, n_layers=5, uno_out_channels=(8, 16, 16, 16, 8),
                        uno_n_modes=((4, 4),) * 5,
                        uno_scalings=((1.0, 1.0), (0.5, 0.5), (1, 1), (2, 2), (1, 1)),
                        channel_mlp_skip="linear"), (4, 2, 16, 16)),
    "rno": ("RNO", dict(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=8,
                        n_layers=2), (4, 3, 1, 12, 12)),
    "codano": ("CODANO", dict(n_modes=((4, 4),) * 2, n_layers=2, hidden_variable_codimension=4,
                              lifting_channels=8, projection_channels=8,
                              per_channel_attention=False, attention_token_dim=1,
                              domain_padding=None), (4, 3, 12, 12)),
    "local_no": ("LocalNO", dict(n_modes=(6, 6), in_channels=2, out_channels=1,
                                 hidden_channels=8, default_in_shape=(16, 16), n_layers=2),
                 (4, 2, 16, 16)),
    "sfno": ("SFNO", dict(n_modes=(8, 8), in_channels=2, out_channels=2, hidden_channels=8,
                          n_layers=2), (4, 2, 16, 32)),
}


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port(cls_name, kwargs, params):
    """The port model of ``cls_name`` holding the flax ``params``."""
    from neuraloperator_tpu_torch import convert, models

    model = getattr(models, cls_name)(**kwargs, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return model


def _flat_grads(model):
    """Every parameter's gradient, a model slice's gathered to the whole leaf's."""
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    return {n: g.numpy().copy() for n, g in mesh_lib.gather_state_dict(model, grads).items()}


def _flat_params(model):
    """Every parameter, a model slice gathered to the whole leaf."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    return {n: t.numpy().copy() for n, t in mesh_lib.gather_state_dict(model, params).items()}


def _lp(reduction):
    from neuraloperator_tpu_torch.losses import LpLoss

    return LpLoss(d=2, reduction=reduction)


# strong enough that a penalty gradient counted twice moves the gradients
PENALTY = 0.1


def _penalty(params):
    """The port's regularizer: PENALTY times the squares of every parameter
    (``params`` the flat {dotted name: tensor} dict)."""
    return PENALTY * sum((v.float() ** 2).sum() for v in params.values())


# --------------------------------------------------------------------------- the ranks


def _case_init(rank, inputs):
    mesh = mesh_lib.init(model_parallel_size=2, device="cpu")
    return {"shape": dict(mesh.shape), "coords": (mesh.data_rank, mesh.model_rank),
            "sizes": (mesh_lib.get_data_parallel_size(), mesh_lib.get_model_parallel_size()),
            "ranks": (comm.get_data_parallel_rank(), comm.get_model_parallel_rank(),
                      comm.get_global_rank(), comm.get_world_size())}


def _case_dp_loss_grads(rank, inputs):
    mesh = mesh_lib.init(model_parallel_size=1, device="cpu")
    model = _port("FNO", FNO_KW, inputs["fno_params"])
    batch = mesh_lib.shard_batch({"x": inputs["x"], "y": inputs["y"]}, mesh)
    loss = _lp("mean")(model(batch["x"]), batch["y"])
    loss.backward()
    comm.reduce_gradients(list(model.parameters()), mesh.data_group, "mean")
    return {"loss": float(comm.reduce_value(loss.detach(), mesh.data_group, "mean")),
            "grads": _flat_grads(model), "local_batch": len(batch["x"]),
            "global_batch": batch.global_batch_size}


def _case_tp_forward(rank, inputs):
    mesh = mesh_lib.init(model_parallel_size=2, device="cpu")
    out = {}
    for name, (cls, kwargs, params) in inputs["tp_models"].items():
        model = mesh_lib.shard_params(_port(cls, kwargs, params), mesh)
        with torch.no_grad():
            out[name] = (model(torch.from_numpy(inputs["x_tp"])).numpy(),
                         list(model.model_parallel_params))
    return out


def _case_dp_tp_train_step(rank, inputs):
    """One AdamW step of the Trainer on a 2 x 2 mesh (data x model)."""
    from neuraloperator_tpu_torch.training import Trainer, adamw

    mesh = mesh_lib.init(model_parallel_size=2, device="cpu")
    model = _port("FNO", FNO_KW, inputs["fno_params"])
    trainer = Trainer(model=model, n_epochs=1, device="cpu", mesh=mesh)
    loader = [{"x": inputs["x"], "y": inputs["y"]}]
    metrics = trainer.train(loader, {}, adamw(1e-3, weight_decay=1e-4),
                            training_loss=_lp("sum"))
    return {"train_err": metrics["train_err"], "params": _flat_params(model),
            "sharded": list(model.model_parallel_params)}


def _case_tfno_dp_tp_grads(rank, inputs):
    mesh = mesh_lib.init(model_parallel_size=2, device="cpu")
    model = mesh_lib.shard_params(_port("FNO", TFNO_KW, inputs["tfno_params"]), mesh)
    batch = mesh_lib.shard_batch({"x": inputs["x"], "y": inputs["y"]}, mesh)
    _lp("mean")(model(batch["x"]), batch["y"]).backward()
    comm.reduce_gradients(list(model.parameters()), mesh.data_group, "mean")
    return _flat_grads(model)


def _case_families(rank, inputs):
    """Each family's forward on its data rank's slice, gathered over the ranks."""
    mesh = mesh_lib.init(model_parallel_size=1, device="cpu")
    out = {}
    for name, (cls, kwargs, params, x) in inputs["families"].items():
        model = mesh_lib.shard_params(_port(cls, kwargs, params), mesh)
        batch = mesh_lib.shard_batch({"x": x}, mesh)
        with torch.no_grad():
            y = model(batch["x"])
        out[name] = comm.all_gather_along(y, 0, mesh.data_group).numpy()
    return out


def _case_batches(rank, inputs):
    """make_distributed_batch of a rank's own samples, shard_batch of the
    global batch, and PrefetchLoader(mesh=) over global batches."""
    from neuraloperator_tpu_torch.data.datasets import PrefetchLoader

    mesh = mesh_lib.init(model_parallel_size=1, device="cpu")
    x, y = inputs["x"], inputs["y"]
    half = slice(rank * 4, rank * 4 + 4)
    local = mesh_lib.make_distributed_batch({"x": x[half], "y": y[half]}, mesh)
    sharded = mesh_lib.shard_batch({"x": x, "y": y}, mesh)
    fetched = list(PrefetchLoader([{"x": x, "y": y}] * 2, mesh=mesh))
    return {"local": {k: v.numpy() for k, v in local.items()},
            "local_size": local.global_batch_size,
            "sharded": {k: v.numpy() for k, v in sharded.items()},
            "fetched": [{k: v.numpy() for k, v in b.items()} for b in fetched],
            "fetched_size": [b.global_batch_size for b in fetched],
            "again": mesh_lib.shard_batch(sharded, mesh) is sharded}


def _case_trainer_steps(rank, inputs):
    """Data-parallel Trainer steps, sum- and mean-reduced losses."""
    from neuraloperator_tpu_torch.training import Trainer, adamw

    mesh = mesh_lib.init(model_parallel_size=1, device="cpu")
    out = {}
    for reduction in ("sum", "mean"):
        model = _port("FNO", FNO_KW, inputs["fno_params"])
        trainer = Trainer(model=model, n_epochs=1, device="cpu", use_distributed=True)
        loader = [{"x": inputs["x"], "y": inputs["y"]}]
        metrics = trainer.train(loader, {"test": loader}, adamw(1e-3, weight_decay=1e-4),
                                training_loss=_lp(reduction),
                                eval_losses={"l2": _lp(reduction)})
        out[reduction] = {"metrics": metrics, "params": {
            n: p.detach().numpy().copy() for n, p in model.named_parameters()}}
    with pytest.raises(ValueError, match="device_dataset"):
        Trainer(model=_port("FNO", FNO_KW, inputs["fno_params"]), n_epochs=1, device="cpu",
                mesh=mesh).train([{"x": inputs["x"], "y": inputs["y"]}], {},
                                 adamw(1e-3), device_dataset=True)
    return out


def _case_tp_regularized(rank, inputs):
    """One Trainer step with a regularizer on a data 1 x model 2 mesh, sum-
    and mean-reduced: the loss, the gradients and the updated parameters."""
    from neuraloperator_tpu_torch.training import Trainer, adamw

    mesh = mesh_lib.init(model_parallel_size=2, device="cpu")
    out = {}
    for reduction in ("sum", "mean"):
        model = _port("FNO", FNO_KW, inputs["fno_params"])
        trainer = Trainer(model=model, n_epochs=1, device="cpu", mesh=mesh)
        metrics = trainer.train([{"x": inputs["x"], "y": inputs["y"]}], {}, adamw(1e-3),
                                training_loss=_lp(reduction), regularizer=_penalty)
        out[reduction] = {"train_err": metrics["train_err"], "grads": _flat_grads(model),
                          "params": _flat_params(model),
                          "sharded": list(model.model_parallel_params)}
    return out


def _case_ns_script(rank, inputs):
    """train_navier_stokes with --distributed.use_distributed true."""
    from neuraloperator_tpu_torch.data.datasets import navier_stokes as tns
    from neuraloperator_tpu_torch.scripts import train_navier_stokes as tscript

    tns.DATA_ROOT = inputs["ns_data"]
    return tscript.main([*inputs["ns_args"], "--distributed.use_distributed", "true",
                         "--device", "cpu"])


CASES = {
    2: ["dp_loss_grads", "tp_forward", "families", "batches", "trainer_steps",
        "tp_regularized", "ns_script"],
    4: ["init", "dp_tp_train_step", "tfno_dp_tp_grads"],
}


def _ranks_main(rank, world, inputs):
    return {name: globals()[f"_case_{name}"](rank, inputs) for name in CASES[world]}


# ------------------------------------------------------------------------ the JAX side


def _jax_fno(kwargs, seed=2, shape=(8, 1, 8, 8)):
    import jax

    from neuraloperator_tpu.models import FNO as JFNO

    model = JFNO(**kwargs)
    params = model.init(jax.random.PRNGKey(seed), np.zeros(shape, np.float32))["params"]
    return model, params


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import jax

    from neuraloperator_tpu.data.datasets import navier_stokes as jns
    from neuraloperator_tpu.layers.spectral_convolution import SpectralConv as JConv  # noqa
    from neuraloperator_tpu.models import get_model as jget_model
    from neuraloperator_tpu.training import training_state as jts
    from neuraloperator_tpu import models as jmodels

    _, fno_params = _jax_fno(FNO_KW)
    _, tfno_params = _jax_fno(TFNO_KW)
    tp_models = {"fno": ("FNO", FNO_KW, _numpy_tree(fno_params))}
    for fact in ("tucker", "cp"):
        kw = dict(FNO_KW, factorization=fact, rank=0.4, implementation="factorized")
        tp_models[fact] = ("FNO", kw, _numpy_tree(_jax_fno(kw, shape=(4, 1, 8, 8))[1]))
    families = {}
    for name, (cls, kwargs, shape) in FAMILIES.items():
        x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape), np.float32)
        params = getattr(jmodels, cls)(**kwargs).init(jax.random.PRNGKey(1), x)["params"]
        families[name] = (cls, kwargs, _numpy_tree(params), x)
    tmp = tmp_path_factory.mktemp("mesh")
    jns.generate_navier_stokes_files(tmp / "data", n_train=16, n_test=8, res=16, T=0.05, seed=3)
    ns_args = ["--data.n_train", "16", "--data.train_resolution", "16", "--data.n_tests", "[8]",
               "--data.test_resolutions", "[16]", "--data.test_batch_sizes", "[4]",
               "--data.batch_size", "4", "--model.n_modes", "[8,8]",
               "--model.hidden_channels", "8", "--model.n_layers", "2",
               "--opt.learning_rate", "1e-3", "--opt.step_size", "1", "--opt.opt_state",
               "factored", "--opt.training_loss", "h1", "--opt.n_epochs", "2",
               "--eval_interval", "1", "--warm_start_from", str(tmp / "init")]
    from neuraloperator_tpu_torch.scripts.train_navier_stokes import NSConfig
    from neuraloperator_tpu_torch.config import make_config_from_cli

    config = make_config_from_cli(NSConfig, ns_args)
    init = jget_model(config.to_dict()).init(jax.random.PRNGKey(4),
                                             np.zeros((1, 1, 16, 16), np.float32))["params"]
    jts.save_training_state(tmp / "init", "best_model", init)
    return {"fno_params": _numpy_tree(fno_params), "tfno_params": _numpy_tree(tfno_params),
            "x": np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 1, 8, 8))),
            "y": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 1, 8, 8))),
            "x_tp": _rand(5, 4, 1, 8, 8), "tp_models": tp_models, "families": families,
            "ns_data": tmp / "data", "ns_args": ns_args}


@pytest.fixture(scope="module")
def world2(inputs):
    return run_ranks(_ranks_main, 2, (inputs,), timeout_s=300)


@pytest.fixture(scope="module")
def world4(inputs):
    return run_ranks(_ranks_main, 4, (inputs,), timeout_s=300)


def _leaves(params):
    from neuraloperator_tpu_torch import convert

    return convert.flatten_flax(_numpy_tree(params))


# ----------------------------------------------------------------------------- tests


def test_mesh_init_shapes(world4):
    import jax

    from neuraloperator_tpu.parallel import mesh as jmesh

    jm = jmesh.init(model_parallel_size=2)
    # JAX's layout: device i of the world at (i // mp, i % mp)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert (ids == np.arange(jax.device_count()).reshape(-1, 2)).all()
    for rank, got in enumerate(world4):
        got = got["init"]
        assert got["shape"] == {"data": 2, "model": 2}
        assert got["coords"] == divmod(rank, 2) == got["ranks"][:2]
        assert got["sizes"] == (2, 2) and got["ranks"][2:] == (rank, 4)
    assert (mesh_lib.get_data_parallel_size(), mesh_lib.get_model_parallel_size()) == (1, 1)
    assert (comm.get_world_size(), comm.get_global_rank(), comm.get_data_parallel_rank(),
            comm.get_model_parallel_rank()) == (1, 0, 0, 0)
    assert comm.get_data_parallel_group() is None and comm.get_model_parallel_group() is None


def _jax_dp_loss_and_grads(inputs):
    import jax
    from jax.sharding import NamedSharding  # noqa: F401

    from neuraloperator_tpu.losses import LpLoss as JLp
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh

    model, l2 = JFNO(**FNO_KW), JLp(d=2, reduction="mean")

    def loss_fn(p, xx, yy):
        return l2(model.apply({"params": p}, xx), yy)

    mesh = jmesh.init(model_parallel_size=1)
    with mesh:
        xs = jax.device_put(inputs["x"], jmesh.batch_sharding(mesh, 4))
        ys = jax.device_put(inputs["y"], jmesh.batch_sharding(mesh, 4))
        ps = jmesh.replicate(inputs["fno_params"], mesh)
        loss = jax.jit(loss_fn)(ps, xs, ys)
        grads = jax.jit(jax.grad(loss_fn))(ps, xs, ys)
    return float(loss), _leaves(grads)


def test_data_parallel_loss_matches_single_device(world2, inputs):
    loss, _ = _jax_dp_loss_and_grads(inputs)
    for got in world2:
        got = got["dp_loss_grads"]
        assert (got["local_batch"], got["global_batch"]) == (4, 8)
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)


def test_data_parallel_grads_match(world2, inputs):
    _, grads = _jax_dp_loss_and_grads(inputs)
    for got in world2:
        got = got["dp_loss_grads"]["grads"]
        assert set(got) == set(grads)
        for name, g in grads.items():
            np.testing.assert_allclose(got[name], g, **GRAD_TOL, err_msg=name)


def _jax_tp_out(inputs, name):
    import jax

    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh

    _, kwargs, params = inputs["tp_models"][name]
    model = JFNO(**kwargs)
    mesh = jmesh.init(model_parallel_size=2)
    with mesh:
        ps = jmesh.shard_params(params, mesh)
        xs = jax.device_put(inputs["x_tp"], jmesh.batch_sharding(mesh, 4))
        return np.asarray(jax.jit(lambda p, v: model.apply({"params": p}, v))(ps, xs))


def test_tensor_parallel_spectral_weights(world2, inputs):
    """Out-channel-split contractions compute the JAX mesh's outputs."""
    want = _jax_tp_out(inputs, "fno")
    for got in world2:
        out, sharded = got["tp_forward"]["fno"]
        assert sharded == ["fno_blocks.conv_0.w_weight", "fno_blocks.conv_1.w_weight"]
        np.testing.assert_allclose(out, want, **FORWARD_TOL)


@pytest.mark.parametrize("factorization", ["tucker", "cp"])
def test_tensor_parallel_tfno_factorized(world2, inputs, factorization):
    """Each model rank holds its out-channel slice of every factorized
    weight's ``w_factor_1``, as the JAX mesh shards it, and contracts it into
    its out channels: the outputs match the JAX mesh's."""
    want = _jax_tp_out(inputs, factorization)
    for got in world2:
        out, sharded = got["tp_forward"][factorization]
        assert sharded == ["fno_blocks.conv_0.w_factor_1", "fno_blocks.conv_1.w_factor_1"]
        np.testing.assert_allclose(out, want, **FORWARD_TOL)


def test_full_train_step_on_mesh(world4, inputs):
    """One data x model (2 x 2) AdamW step through the Trainer: the loss and
    the updated parameters of the JAX mesh's step."""
    import jax
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from neuraloperator_tpu.losses import LpLoss as JLp
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh

    model, l2, opt = JFNO(**FNO_KW), JLp(d=2), optax.adamw(1e-3)
    params = inputs["fno_params"]
    mesh = jmesh.init(model_parallel_size=2)

    def step(p, o, xx, yy):
        loss, grads = jax.value_and_grad(lambda q: l2(model.apply({"params": q}, xx), yy))(p)
        updates, o = opt.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    with mesh:
        ps = jmesh.shard_params(params, mesh)
        os_ = jax.device_put(opt.init(params), NamedSharding(mesh, P()))
        xs = jax.device_put(inputs["x"], jmesh.batch_sharding(mesh, 4))
        ys = jax.device_put(inputs["y"], jmesh.batch_sharding(mesh, 4))
        new_p, _, loss = jax.jit(step)(ps, os_, xs, ys)
    want = _leaves(new_p)
    for got in world4:
        got = got["dp_tp_train_step"]
        assert got["sharded"] == ["fno_blocks.conv_0.w_weight", "fno_blocks.conv_1.w_weight"]
        np.testing.assert_allclose(got["train_err"], float(loss), rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(got["params"][name], w, rtol=2e-4, atol=1e-6,
                                       err_msg=name)


def test_tp_specs_identify_factorizations():
    """tp_param_specs names the out-channel dim of each factorization's weight."""
    import jax

    from neuraloperator_tpu.layers.spectral_convolution import SpectralConv as JConv
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu_torch.layers.spectral_convolution import SpectralConv

    jm = jmesh.init(model_parallel_size=2)
    mesh = SimpleNamespace(shape={"data": 4, "model": 2})
    x = np.zeros((2, 8, 8, 8), np.float32)
    for fact in (None, "cp", "tucker", "tt"):
        params = JConv(in_channels=8, out_channels=8, n_modes=(4, 4), factorization=fact,
                       rank=0.5).init(jax.random.PRNGKey(1), x)["params"]
        want = {k: [i for i, s in enumerate(v.spec) if s == "model"]
                for k, v in jmesh.tp_param_specs(params, jm).items()}
        conv = SpectralConv(8, 8, (4, 4), factorization=fact, rank=0.5, device="cpu")
        got = mesh_lib.tp_param_specs(conv, mesh)
        assert set(got) == set(want), fact
        for k, dims in want.items():
            assert got[k] == (dims[0] if dims else None), (fact, k)
        assert any(v is not None for v in got.values()), fact


def test_tfno_dp_grads_match(world4, inputs):
    import jax

    from neuraloperator_tpu.losses import LpLoss as JLp
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh

    model, l2 = JFNO(**TFNO_KW), JLp(d=2, reduction="mean")

    def loss_fn(p, xx, yy):
        return l2(model.apply({"params": p}, xx), yy)

    mesh = jmesh.init(model_parallel_size=2)
    with mesh:
        ps = jmesh.shard_params(inputs["tfno_params"], mesh)
        xs = jax.device_put(inputs["x"], jmesh.batch_sharding(mesh, 4))
        ys = jax.device_put(inputs["y"], jmesh.batch_sharding(mesh, 4))
        want = _leaves(jax.jit(jax.grad(loss_fn))(ps, xs, ys))
    for got in world4:
        got = got["tfno_dp_tp_grads"]
        for name, g in want.items():
            np.testing.assert_allclose(got[name], g, rtol=5e-4, atol=1e-5, err_msg=name)


def _jax_family_out(name, inputs):
    import jax

    from neuraloperator_tpu import models as jmodels
    from neuraloperator_tpu.parallel import mesh as jmesh

    cls, kwargs, params, x = inputs["families"][name]
    model = getattr(jmodels, cls)(**kwargs)
    mesh = jmesh.init(model_parallel_size=2)
    with mesh:
        ps = jmesh.shard_params(params, mesh)
        xs = jax.device_put(x, jmesh.batch_sharding(mesh, x.ndim))
        return np.asarray(jax.jit(lambda p, v: model.apply({"params": p}, v))(ps, xs))


def test_sfno_on_mesh_matches_single_device(world2, inputs):
    want = _jax_family_out("sfno", inputs)
    for got in world2:
        np.testing.assert_allclose(got["families"]["sfno"], want, **FORWARD_TOL)


@pytest.mark.parametrize("family", ["uno", "rno", "codano", "local_no"])
def test_remaining_families_on_mesh_match_single_device(world2, inputs, family):
    want = _jax_family_out(family, inputs)
    for got in world2:
        np.testing.assert_allclose(got["families"][family], want, **FAMILY_TOL)


def test_make_distributed_batch_multiprocess_branch(world2, inputs):
    """Each rank's own samples make its slice of the global batch, as
    shard_batch cuts it and PrefetchLoader(mesh=) places it."""
    for rank, got in enumerate(world2):
        got = got["batches"]
        half = slice(rank * 4, rank * 4 + 4)
        for k in ("x", "y"):
            want = inputs[k][half]
            np.testing.assert_array_equal(got["local"][k], want)
            np.testing.assert_array_equal(got["sharded"][k], want)
            for batch in got["fetched"]:
                np.testing.assert_array_equal(batch[k], want)
        assert got["local_size"] == 8 and got["fetched_size"] == [8, 8] and got["again"]


def _single_process_trainer(inputs, reduction):
    from neuraloperator_tpu_torch.training import Trainer, adamw

    model = _port("FNO", FNO_KW, inputs["fno_params"])
    trainer = Trainer(model=model, n_epochs=1, device="cpu")
    loader = [{"x": inputs["x"], "y": inputs["y"]}]
    metrics = trainer.train(loader, {"test": loader}, adamw(1e-3, weight_decay=1e-4),
                            training_loss=_lp(reduction), eval_losses={"l2": _lp(reduction)})
    return metrics, {n: p.detach().numpy() for n, p in model.named_parameters()}


def _jax_trainer_on_mesh(inputs, reduction, model_parallel_size=1, regularizer=None):
    import optax

    from neuraloperator_tpu.losses import LpLoss as JLp
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.training import Trainer as JTrainer

    loader = [{"x": inputs["x"], "y": inputs["y"]}]
    trainer = JTrainer(model=JFNO(**FNO_KW), n_epochs=1,
                       mesh=jmesh.init(model_parallel_size=model_parallel_size))
    trainer.params = inputs["fno_params"]
    metrics = trainer.train(loader, {"test": loader}, optax.adamw(1e-3),
                            training_loss=JLp(d=2, reduction=reduction),
                            eval_losses={"l2": JLp(d=2, reduction=reduction)},
                            regularizer=regularizer)
    return metrics, _leaves(trainer.params)


def _jax_penalty(params):
    import jax
    import jax.numpy as jnp

    return PENALTY * sum(jnp.sum(leaf.astype(jnp.float32) ** 2)
                         for leaf in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_data_parallel_trainer_step_matches_one_process_and_jax(world2, inputs, reduction):
    """A world-2 Trainer step (4 rows a rank) against the one-process step on
    the 8 rows and the JAX Trainer's step on its 8-device mesh: the loss,
    the evaluation and every updated parameter."""
    one, one_params = _single_process_trainer(inputs, reduction)
    jax_metrics, jax_params = _jax_trainer_on_mesh(inputs, reduction)
    for got in world2:
        got = got["trainer_steps"][reduction]
        for k in ("train_err", "test_l2"):
            np.testing.assert_allclose(got["metrics"][k], one[k], rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(got["metrics"][k], jax_metrics[k], rtol=1e-5, err_msg=k)
        for name, w in one_params.items():
            np.testing.assert_allclose(got["params"][name], w, rtol=2e-4, atol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(got["params"][name], jax_params[name], rtol=2e-4,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_regularizer_on_a_model_parallel_mesh(world2, inputs, reduction):
    """A regularized Trainer step on a data 1 x model 2 mesh, whose spectral
    weights contract by out-channel slices, against the one-process step
    (loss, every gradient, every updated parameter) and the JAX Trainer's
    step on its 4 x 2 mesh (loss and parameters): the penalty's gradient
    counts once on the sliced weights too."""
    from neuraloperator_tpu_torch.training import Trainer, adamw

    model = _port("FNO", FNO_KW, inputs["fno_params"])
    one = Trainer(model=model, n_epochs=1, device="cpu").train(
        [{"x": inputs["x"], "y": inputs["y"]}], {}, adamw(1e-3),
        training_loss=_lp(reduction), regularizer=_penalty)
    one_grads, one_params = _flat_grads(model), {n: p.detach().numpy()
                                                 for n, p in model.named_parameters()}
    jax_metrics, jax_params = _jax_trainer_on_mesh(inputs, reduction, 2, _jax_penalty)
    for got in world2:
        got = got["tp_regularized"][reduction]
        assert got["sharded"] == ["fno_blocks.conv_0.w_weight", "fno_blocks.conv_1.w_weight"]
        np.testing.assert_allclose(got["train_err"], one["train_err"], rtol=1e-5)
        np.testing.assert_allclose(got["train_err"], jax_metrics["train_err"], rtol=1e-5)
        for name, g in one_grads.items():
            np.testing.assert_allclose(got["grads"][name], g, **GRAD_TOL, err_msg=name)
        for name, w in one_params.items():
            np.testing.assert_allclose(got["params"][name], w, **GRAD_TOL, err_msg=name)
            np.testing.assert_allclose(got["params"][name], jax_params[name], **GRAD_TOL,
                                       err_msg=name)


def test_ns_script_use_distributed_matches_one_process(world2, inputs):
    """``train_navier_stokes --distributed.use_distributed true`` on two
    ranks against the same script in one process (the JAX script's
    mesh would split a batch of 4 over 8 devices, which it refuses)."""
    from neuraloperator_tpu_torch.data.datasets import navier_stokes as tns
    from neuraloperator_tpu_torch.scripts import train_navier_stokes as tscript

    root = tns.DATA_ROOT
    try:
        tns.DATA_ROOT = inputs["ns_data"]
        want = tscript.main([*inputs["ns_args"], "--device", "cpu"])
    finally:
        tns.DATA_ROOT = root
    for got in world2:
        got = got["ns_script"]
        assert set(got) == set(want)
        for k in ("train_err", "16_h1", "16_l2"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_helpers_match_jax():
    import jax.numpy as jnp

    from neuraloperator_tpu.parallel import comm as jcomm

    x = _rand(6, 2, 6, 5) + 1j * _rand(7, 2, 6, 5)
    for dim, size in ((1, 9), (-1, 8), (1, 6)):
        for mode in ("zero", "conj"):
            np.testing.assert_array_equal(
                comm.pad_helper(torch.from_numpy(x), dim, size, mode).numpy(),
                np.asarray(jcomm.pad_helper(jnp.asarray(x), dim, size, mode)))
        np.testing.assert_array_equal(comm.truncate_helper(torch.from_numpy(x), dim, 3).numpy(),
                                      np.asarray(jcomm.truncate_helper(jnp.asarray(x), dim, 3)))
    for got, want in zip(comm.split_tensor_along_dim(torch.from_numpy(x), 1, 3),
                         jcomm.split_tensor_along_dim(jnp.asarray(x), 1, 3)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="not divisible"):
        comm.split_tensor_along_dim(torch.from_numpy(x), 1, 4)
    with pytest.raises(ValueError, match="smaller"):
        comm.pad_helper(torch.from_numpy(x), 1, 2)
    assert comm.get_memory_format(torch.zeros(2, 3)) == jcomm.get_memory_format(None)
    assert comm.get_memory_format(torch.zeros(2, 3, 4, 5).to(
        memory_format=torch.channels_last)) == "channels_last"
    # without a mesh every collective is the identity
    t = torch.randn(4, 2)
    for fn in (comm.copy_to_model_parallel_region, comm.reduce_from_model_parallel_region):
        assert fn(t) is t
    assert comm.scatter_to_model_parallel_region(t, 0) is t
    assert comm.gather_from_model_parallel_region(t, 0) is t
    assert mesh_lib.shard_batch({"x": t}) == {"x": t}


def test_a_failing_rank_ends_the_group():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(_fail_on_rank_one, 2, timeout_s=60)
    with pytest.raises(TimeoutError, match="did not finish"):
        run_ranks(_hang_on_rank_one, 2, timeout_s=15)
    with pytest.raises(RuntimeError, match="rank 1 ended with exit code 0 and no result"):
        run_ranks(_exit_on_rank_one, 2, (np.zeros(1 << 20),), timeout_s=60)


def _exit_on_rank_one(rank, world, big):
    if rank == 1:
        os._exit(0)  # leaves without a word
    return rank


def _fail_on_rank_one(rank, world):
    if rank == 1:
        raise ValueError("boom")
    return rank


def _hang_on_rank_one(rank, world):
    if rank == 0:
        time.sleep(120)  # never joins rank 1's collective
    else:
        torch.distributed.barrier()  # a hung collective
    return rank


def test_setup_builds_no_mesh_unless_asked():
    """Without a model-parallel size, setup() joins no process group and
    returns None, as the JAX setup; with one, each rank of the script case
    above built its mesh through it."""
    import torch.distributed as dist

    from neuraloperator_tpu_torch.training.setup import setup

    assert setup(matmul_precision="highest") is None
    assert not dist.is_initialized() and mesh_lib.get_mesh() is None
