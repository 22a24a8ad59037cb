"""ZeRO-1 through ``parallel.zero`` at gloo world size 2 on the CPU, against
the replicated run and the JAX package (the cases of ``tests/test_zero.py``).

The cut state must change where the state lives, not what the optimizer
computes: the ZeRO run is held to the replicated run of the same ranks
(parameters within ``atol=1e-6``, as JAX's test holds its own) and to the
one-process port run and the JAX run (parameters within ``rtol=2e-4,
atol=1e-6``, the data-parallel gradients' bound; losses within 1e-5).
One group of spawned ranks runs every case; the JAX side runs in the test
process.
"""

import numpy as np
import pytest
import torch

from neuraloperator_tpu_torch.parallel import mesh as mesh_lib
from neuraloperator_tpu_torch.parallel import zero as zero_lib
from neuraloperator_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

FNO_KW = dict(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=8, n_layers=2)
POLICIES = {"adamw": dict(weight_decay=1e-4),
            "factored_adamw": dict(weight_decay=1e-4, factored_second_moment=True),
            "factored_adamw_int8mu": dict(weight_decay=1e-4, factored_second_moment=True,
                                          mu_dtype="int8")}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _model(params):
    from neuraloperator_tpu_torch import convert
    from neuraloperator_tpu_torch.models import FNO

    model = FNO(**FNO_KW, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return model


def _mse(out, y):
    return torch.mean((out - y) ** 2)


_mse.reduction = "mean"


def _steps(model, opt, x, y, n, mesh=None):
    """``n`` steps of the mean squared error, the gradients averaged over
    the data ranks of ``mesh``."""
    from neuraloperator_tpu_torch.parallel import comm

    if mesh is not None:
        batch = mesh_lib.shard_batch({"x": x, "y": y}, mesh)
        x, y = batch["x"], batch["y"]
    else:
        x, y = torch.as_tensor(x), torch.as_tensor(y)
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        loss = _mse(model(x), y)
        loss.backward()
        if mesh is not None:
            comm.reduce_gradients(list(model.parameters()), mesh.data_group, "mean")
            loss = comm.reduce_value(loss.detach(), mesh.data_group, "mean")
        opt.step()
    return float(loss), {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _leaf_sizes(zero):
    """(local elements, whole elements) of each cut state leaf."""
    out = []
    for (name, p), dim, loc in zip(zero.params, zero.dims, zero.local):
        if dim is None:
            continue
        for t in zero.inner.state[loc].values():
            if t.ndim > dim:
                out.append((t.numel(), t.numel() * 2))
    return out


# --------------------------------------------------------------------------- the ranks


def _case_zero_matches_replicated(rank, inputs):
    from neuraloperator_tpu_torch.training import adamw

    mesh = mesh_lib.init(model_parallel_size=1, device="cpu")
    out = {}
    for name, kw in POLICIES.items():
        tx = adamw(1e-3, **kw)
        model = _model(inputs["params"])
        replicated = _steps(model, tx.bind(model.named_parameters()), inputs["x"],
                            inputs["y"], 3, mesh)
        model = _model(inputs["params"])
        zero = zero_lib.ZeroAdamW(tx, model.named_parameters(), mesh)
        cut = _steps(model, zero, inputs["x"], inputs["y"], 3, mesh)
        out[name] = {"replicated": replicated, "zero": cut, "sizes": _leaf_sizes(zero)}
    return out


def _case_trainer_zero(rank, inputs):
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.training import Trainer, adamw

    mesh = mesh_lib.init(model_parallel_size=1, device="cpu")
    loader = [{"x": inputs["x"], "y": inputs["y"]}]
    out = {}
    for zero in (False, True):
        model = _model(inputs["params"])
        trainer = Trainer(model=model, n_epochs=2, device="cpu", mesh=mesh, zero_sharding=zero)
        metrics = trainer.train(loader, {"test": loader}, adamw(1e-3, weight_decay=1e-4),
                                training_loss=LpLoss(d=2))
        out[zero] = (metrics, {n: p.detach().numpy().copy()
                               for n, p in model.named_parameters()},
                     type(trainer.optimizer).__name__)
    return out


def _case_ema(rank, inputs):
    from neuraloperator_tpu_torch.training import adamw, ema_params, with_ema

    mesh = mesh_lib.init(model_parallel_size=1, device="cpu")
    out = {}
    for cut in (False, True):
        model = _model(inputs["params"])
        tx = with_ema(adamw(1e-3, weight_decay=1e-4), decay=0.9)
        opt = (zero_lib.ZeroAdamW(tx, model.named_parameters(), mesh) if cut
               else tx.bind(model.named_parameters()))
        loss, _ = _steps(model, opt, inputs["x"], inputs["y"], 2, mesh)
        ema = {n: t.numpy().copy() for n, t in ema_params(opt).items()}
        local = ([(opt.inner.state[loc]["ema"].numel(), p.numel())
                  for (_, p), d, loc in zip(opt.params, opt.dims, opt.local) if d is not None]
                 if cut else [])
        out[cut] = (loss, ema, local)
    return out


def _case_resume(rank, inputs):
    """A ZeRO run saved after 2 epochs and resumed to 3, by ZeRO and by a
    replicated run, against 3 replicated epochs in one go."""
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.training import Trainer, build_optimizer

    mesh = mesh_lib.init(model_parallel_size=1, device="cpu")
    loader = [{"x": inputs["x"][:4], "y": inputs["y"][:4]},
              {"x": inputs["x"][4:], "y": inputs["y"][4:]}]
    opt = inputs["opt_cfg"]
    root = inputs["tmp"]

    def run(n_epochs, zero, save, resume=None):
        model = _model(inputs["params"])
        trainer = Trainer(model=model, n_epochs=n_epochs, device="cpu", mesh=mesh,
                          zero_sharding=zero)
        metrics = trainer.train(loader, {"test": loader}, build_optimizer(opt, 2),
                                training_loss=LpLoss(d=2), save_dir=root / save,
                                save_every=1, resume_from_dir=resume)
        return metrics, {n: p.detach().numpy().copy() for n, p in model.named_parameters()}

    whole = run(3, False, "whole")
    run(2, True, "zero")
    torch.distributed.barrier()  # rank 0's files are written
    return {"whole": whole, "zero_resumed": run(3, True, "zero_z", root / "zero"),
            "replicated_resumed": run(3, False, "zero_r", root / "zero")}


def _case_no_copies(rank, inputs):
    """Where ZeroAdamW keeps its slices (views of the parameters at data
    size 2; the parameters themselves at data size 1, on a data 1 x model 2
    mesh), and that the Trainer under ZeRO binds no replicated optimizer."""
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.training import Trainer, adamw

    out = {}
    tx = adamw(1e-3, weight_decay=1e-4, factored_second_moment=True)
    for mp in (1, 2):
        mesh = mesh_lib.init(model_parallel_size=mp, device="cpu")
        zero = zero_lib.ZeroAdamW(tx, _model(inputs["params"]).named_parameters(), mesh)
        pairs = [(p, loc) for (_, p), loc in zip(zero.params, zero.local)]
        out[mp] = {"cut": sum(d is not None for d in zero.dims),
                   "shared": all(loc.untyped_storage().data_ptr()
                                 == p.untyped_storage().data_ptr() for p, loc in pairs),
                   "same": all(loc is p for p, loc in pairs)}

    def refuse(*args, **kwargs):
        raise AssertionError("the Trainer bound a replicated optimizer under ZeRO")

    tx = adamw(1e-3)
    tx.bind = refuse
    trainer = Trainer(model=_model(inputs["params"]), n_epochs=1, device="cpu",
                      mesh=mesh_lib.init(model_parallel_size=1, device="cpu"),
                      zero_sharding=True)
    trainer.train([{"x": inputs["x"], "y": inputs["y"]}], {}, tx, training_loss=LpLoss(d=2))
    out["optimizer"] = type(trainer.optimizer).__name__
    return out


CASES = ["zero_matches_replicated", "trainer_zero", "ema", "resume", "no_copies"]


def _ranks_main(rank, world, inputs):
    return {name: globals()[f"_case_{name}"](rank, inputs) for name in CASES}


# ------------------------------------------------------------------------ the JAX side


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    import jax
    from types import SimpleNamespace

    from neuraloperator_tpu.models import FNO as JFNO

    x = jax.random.normal(jax.random.PRNGKey(0), (8, 1, 8, 8))
    y = jax.random.normal(jax.random.PRNGKey(1), (8, 1, 8, 8))
    params = JFNO(**FNO_KW).init(jax.random.PRNGKey(2), x)["params"]
    return {"params": _numpy_tree(params), "x": np.asarray(x), "y": np.asarray(y),
            "tmp": tmp_path_factory.mktemp("zero"),
            "opt_cfg": SimpleNamespace(learning_rate=1e-3, step_size=1, gamma=0.5,
                                       weight_decay=1e-4, opt_state="factored")}


@pytest.fixture(scope="module")
def world2(inputs):
    return run_ranks(_ranks_main, 2, (inputs,), timeout_s=300)


def _leaves(params):
    from neuraloperator_tpu_torch import convert

    return convert.flatten_flax(_numpy_tree(params))


def _jax_steps(inputs, make_opt, n=3):
    import jax
    import jax.numpy as jnp
    import optax

    from neuraloperator_tpu.models import FNO as JFNO

    model = JFNO(**FNO_KW)
    opt = make_opt()
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda q: jnp.mean((model.apply({"params": q}, inputs["x"]) - inputs["y"]) ** 2))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    for _ in range(n):
        params, state, loss = step(params, state)
    return float(loss), _leaves(params)


def _jax_policy(name):
    import optax

    from neuraloperator_tpu.training.optimizer import adamw as jadamw

    return {"adamw": lambda: optax.adamw(1e-3),
            "factored_adamw": lambda: jadamw(1e-3, factored_second_moment=True),
            "factored_adamw_int8mu": lambda: jadamw(1e-3, factored_second_moment=True,
                                                    mu_dtype="int8")}[name]


@pytest.mark.parametrize("policy", list(POLICIES))
def test_zero_matches_replicated(world2, inputs, policy):
    jax_loss, jax_params = _jax_steps(inputs, _jax_policy(policy))
    for got in world2:
        got = got["zero_matches_replicated"][policy]
        (loss_r, rep), (loss_z, cut) = got["replicated"], got["zero"]
        np.testing.assert_allclose(loss_z, loss_r, rtol=1e-6)
        np.testing.assert_allclose(loss_z, jax_loss, rtol=1e-5)
        for name, ref in rep.items():
            np.testing.assert_allclose(cut[name], ref, atol=1e-6, err_msg=name)
            # int8 first moments round the same f32 moment to a code either
            # way after a 1e-7 difference of the ranks' sums: bf16-ulp-sized
            tol = dict(rtol=2e-4, atol=1e-6) if policy == "adamw" else dict(rtol=2e-3,
                                                                             atol=2e-5)
            np.testing.assert_allclose(cut[name], jax_params[name], **tol, err_msg=name)
        # the state is cut: every cut leaf keeps half its elements on each rank
        assert got["sizes"] and all(2 * n == whole for n, whole in got["sizes"])


def test_zero_specs_shapes():
    """zero_specs names JAX's dims (here with its 8-way data axis)."""
    from types import SimpleNamespace

    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel import zero as jzero

    tree = {"scalar": np.float32(0.0), "odd": np.zeros((3, 5)), "vec": np.zeros((16,)),
            "mat": np.zeros((4, 64, 2)), "nest": [np.zeros((8, 24)), np.zeros((2,))]}
    jm = jmesh.init(model_parallel_size=1)
    want = jzero.zero_specs({k: (jnp.asarray(v) if not isinstance(v, list) else
                                 [jnp.asarray(a) for a in v]) for k, v in tree.items()}, jm)
    got = zero_lib.zero_specs(tree, SimpleNamespace(shape={"data": 8}))

    def dim(spec):
        return next((i for i, s in enumerate(spec) if s == "data"), None)

    assert got["scalar"] is None and want["scalar"] == P()
    for k in ("odd", "vec", "mat"):
        assert got[k] == dim(want[k]), k
    assert got["nest"] == [dim(s) for s in want["nest"]] == [1, None]
    cut = zero_lib.shard_opt_state({"vec": torch.arange(16.0)},
                                   SimpleNamespace(shape={"data": 8}, data_rank=3))
    assert cut["vec"].tolist() == [6.0, 7.0]


def test_trainer_zero_sharding_matches(world2, inputs):
    import optax

    from neuraloperator_tpu.losses import LpLoss as JLp
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.training import Trainer as JTrainer

    loader = [{"x": inputs["x"], "y": inputs["y"]}]
    jt = JTrainer(model=JFNO(**FNO_KW), n_epochs=2, mesh=jmesh.init(model_parallel_size=1),
                  zero_sharding=True)
    jt.params = inputs["params"]
    want = jt.train(loader, {"test": loader}, optax.adamw(1e-3), training_loss=JLp(d=2))
    want_params = _leaves(jt.params)
    for got in world2:
        (m_r, p_r, kind_r), (m_z, p_z, kind_z) = got["trainer_zero"][False], \
            got["trainer_zero"][True]
        assert (kind_r, kind_z) == ("AdamW", "ZeroAdamW")
        for k in m_r:
            if "time" in k:
                continue
            np.testing.assert_allclose(m_z[k], m_r[k], rtol=2e-5, err_msg=k)
            np.testing.assert_allclose(m_z[k], want[k], rtol=2e-5, err_msg=k)
        for name, ref in p_r.items():
            np.testing.assert_allclose(p_z[name], ref, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(p_z[name], want_params[name], rtol=2e-4, atol=1e-6,
                                       err_msg=name)


def test_zero_shards_ema_state(world2):
    """with_ema rides the optimizer state, so ZeRO cuts the EMA too; gathered,
    it is the replicated run's EMA."""
    for got in world2:
        (loss_r, ema_r, _), (loss_z, ema_z, local) = got["ema"][False], got["ema"][True]
        assert np.isfinite(loss_z)
        np.testing.assert_allclose(loss_z, loss_r, rtol=1e-6)
        assert local and all(2 * n == whole for n, whole in local)
        for name, ref in ema_r.items():
            np.testing.assert_allclose(ema_z[name], ref, atol=1e-6, err_msg=name)


def test_a_zero_checkpoint_resumes(world2, inputs):
    """The ZeRO run's files (``optimizer.msgpack`` in the JAX tree, written by
    rank 0 from the gathered state) resume under ZeRO and replicated, to
    the metrics and parameters of 3 epochs run in one go."""
    from neuraloperator_tpu_torch.serialization import read_msgpack

    tree = read_msgpack(inputs["tmp"] / "zero" / "optimizer.msgpack")
    assert int(np.asarray(tree["0"]["count"])) == 4  # 2 epochs of 2 steps
    for got in world2:
        got = got["resume"]
        m_w, p_w = got["whole"]
        for resumed in ("zero_resumed", "replicated_resumed"):
            m, p = got[resumed]
            for k in ("train_err", "test_l2"):
                np.testing.assert_allclose(m[k], m_w[k], rtol=1e-5, err_msg=(resumed, k))
            for name, ref in p_w.items():
                np.testing.assert_allclose(p[name], ref, rtol=2e-4, atol=1e-6,
                                           err_msg=(resumed, name))


def test_zero_slices_are_views_and_data_size_one_cuts_nothing(world2):
    """ZeRO adds no copy of the parameters: at data size 2 each local slice
    shares its parameter's storage, at data size 1 the optimizer updates
    the parameters themselves, and the Trainer binds only ``ZeroAdamW``."""
    for got in world2:
        got = got["no_copies"]
        assert got[1]["cut"] > 0 and got[1]["shared"] and not got[1]["same"]
        assert got[2]["cut"] == 0 and got[2]["same"]
        assert got["optimizer"] == "ZeroAdamW"
