"""The model axis holding slices (``parallel.mesh.shard_params``), the
optimizer on slices (AdamW, and Tensor-GaLore also under ZeRO) and the
sharded checkpoint (``save/load_training_state_orbax`` over
``torch.distributed.checkpoint``), at gloo world sizes 2 (data 1 x model 2)
and 4 (data 2 x model 2) on the CPU, against the JAX package.

Each world size is one group of spawned ranks (``parallel.launch.run_ranks``)
that runs every case once; the tests read their case's results, and the
JAX side runs in the test process. JAX's answers do not depend on its mesh,
so each is taken once, on whole arrays. Tolerances are those of
``tests/test_torch_mesh.py`` (forwards ``rtol=2e-4, atol=1e-5``; a Trainer
step's parameters ``rtol=2e-4, atol=1e-6``) and of
``tests/test_torch_optimizer.py`` and ``test_torch_training_extras.py``
(f32 moments ``rtol=1e-6, atol=1e-8``, the bound of its clipped runs; a
bf16 first moment ``atol=2**-8 * lr * steps``): a model rank sums its
slice's terms in another order than one process sums the whole leaf's.
Shards, gathers and checkpoints are held to the bit.
"""

import numpy as np
import pytest
import torch

from neuraloperator_tpu_torch.parallel import mesh as mesh_lib
from neuraloperator_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

FNO_KW = dict(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=8, n_layers=2)
# the layouts JAX shards, with the leaves and the dim it shards: the out
# channels of a dense weight or of a factorization's w_factor_1; the first
# modes of a separable weight (2, in, m1, m2) and the in channels of a
# scanned stack (n_layers, 2, in, out, m1, m2), which the port gathers for
# each call
FACTORIZATIONS = {"dense": {}, **{f: dict(factorization=f, rank=0.4,
                                          implementation="factorized")
                                  for f in ("cp", "tucker", "tt")},
                  "separable": dict(separable=True), "scan": dict(scan_layers=True)}
SHARDED = {"dense": ("w_weight", 2), "cp": ("w_factor_1", 1), "tucker": ("w_factor_1", 1),
           "tt": ("w_factor_1", 2), "separable": ("w_weight", 2)}
SHARDED = {name: ([f"fno_blocks.conv_{i}.{leaf}" for i in range(2)], dim)
           for name, (leaf, dim) in SHARDED.items()}
SHARDED["scan"] = (["fno_blocks.layers.conv.w_weight"], 2)
FORWARD_TOL = dict(rtol=2e-4, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=1e-6)
# the optimizer's leaves: each spectral layout JAX shards, with the dim it
# shards (the 1-D dense weight's out channels and the factors' are one of
# the two factored axes), and two whole leaves
LEAVES = {"dense.w_weight": ((2, 4, 8, 6, 5), 2), "dense1d.w_weight": ((2, 4, 8, 6), 2),
          "cp.w_factor_1": ((2, 8, 5), 1), "tt.w_factor_1": ((2, 3, 8, 3), 2),
          "mlp.w0": ((7, 3), None), "mlp.b0": ((7,), None)}
# the gradients' scales: the global norm passes MAX_GRAD_NORM on the first
# and third steps, not on the second
GRAD_SCALES, MAX_GRAD_NORM, LR = (3.0, 0.01, 2.0), 1.0, 1e-2
# Tensor-GaLore on the slices. Through the Trainer: rank 1, so each projected
# leaf keeps its leading singular vector alone in every truncated mode (a
# model's gradients here are dominated by one direction, and the vectors of
# kept singular values that nearly vanish, or nearly tie, are rounding
# noise that Adam scales to full steps: ROADMAP C), three one-batch epochs
# with refreshes at steps 1 and 3. On its own: rank 7 on leaves of random
# gradients (a 5-D and a 4-D spectral layout sliced along their out
# channels, a matrix keeping one side whole, plain leaves sliced, cut by
# ZeRO or whole), three steps with the same refreshes.
GALORE_KW = dict(FNO_KW, hidden_channels=16)
GALORE = dict(rank=1, update_proj_gap=2, galore_scale=0.25, weight_decay=1e-2,
              min_dim_size_to_project=2)
GALORE_LR, GALORE_EPOCHS = 1e-2, 3
GALORE_LEAVES = {"conv.w_weight": ((2, 8, 16, 6, 5), 2), "conv1d.w_weight": ((2, 4, 8, 6), 2),
                 "mlp.w0": ((7, 9), None), "mlp.b0": ((7,), None), "skip.w": ((6, 1), None),
                 "norm.w": ((16,), 0)}
POLICIES = {"full": dict(max_grad_norm=MAX_GRAD_NORM),
            "factored": dict(factored_second_moment=True, mu_dtype="bf16"),
            "factored8": dict(factored_second_moment=True, mu_dtype="int8")}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _port(kwargs, params):
    from neuraloperator_tpu_torch import convert
    from neuraloperator_tpu_torch.models import FNO

    model = FNO(**kwargs, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return model


def _whole(model, tensors=None) -> dict:
    tensors = {n: p.detach() for n, p in model.named_parameters()} if tensors is None \
        else tensors
    return {n: t.numpy().copy() for n, t in mesh_lib.gather_state_dict(model, tensors).items()}


def _draws(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, (s, _) in LEAVES.items()}


def _port_transform(policy):
    """The port's AdamW of ``policy`` on the step_lr schedule (a stair every
    two steps), whose optax state carries its count."""
    from neuraloperator_tpu_torch.training import adamw, step_lr

    kw = dict(POLICIES[policy])
    kw["mu_dtype"] = {"bf16": torch.bfloat16, "int8": "int8", None: None}[kw.get("mu_dtype")]
    return adamw(step_lr(LR, 1, 0.5, 2), weight_decay=1e-2, **kw)


def _jax_transform(policy):
    """The JAX package's AdamW of ``policy``, as ``_port_transform``."""
    import jax.numpy as jnp

    from neuraloperator_tpu.training import optimizer as jopt

    kw = dict(POLICIES[policy])
    kw["mu_dtype"] = {"bf16": jnp.bfloat16, "int8": "int8", None: None}[kw.get("mu_dtype")]
    return jopt.adamw(jopt.step_lr(LR, 1, 0.5, 2), weight_decay=1e-2, **kw)


def _galore_transform(**kw):
    from neuraloperator_tpu_torch.training import tensor_galore_adamw

    return tensor_galore_adamw(GALORE_LR, **{**GALORE, **kw})


def _galore_draws(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in GALORE_LEAVES.items()}


def _flat_state(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_state(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(torch.as_tensor(v).float()) \
                if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


# --------------------------------------------------------------------------- the ranks


def _case_shards(rank, inputs):
    """Each factorization sharded: its slices' sizes, the gathered tree and
    the forward."""
    mesh = mesh_lib.get_mesh()
    out = {}
    for name, kw in FACTORIZATIONS.items():
        model = _port(dict(FNO_KW, **kw), inputs["params"][name])
        whole = {k: v.clone() for k, v in model.state_dict().items()}
        mesh_lib.shard_params(model, mesh)
        held = dict(model.named_parameters())
        back = mesh_lib.gather_state_dict(model)
        with torch.no_grad():
            y = model(torch.from_numpy(inputs["x"]))
        out[name] = {
            "sharded": {k: (s.dim, s.shape, held[k].numel())
                        for k, s in model.model_parallel_params.items()},
            "equal": all(torch.equal(back[k], whole[k]) for k in whole),
            "cut": all(torch.equal(v, mesh_lib.cut_state_dict(model, whole)[k])
                       for k, v in model.state_dict().items()),
            "forward": y.numpy()}
    return out


def _case_trainer(rank, inputs):
    """One AdamW step of the Trainer, replicated and under ZeRO."""
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.training import Trainer, adamw

    mesh = mesh_lib.get_mesh()
    out = {}
    for zero in (False, True):
        model = _port(FNO_KW, inputs["params"]["dense"])
        trainer = Trainer(model=model, n_epochs=1, device="cpu", mesh=mesh, zero_sharding=zero)
        metrics = trainer.train([{"x": inputs["x"], "y": inputs["y"]}], {}, adamw(1e-3),
                                training_loss=LpLoss(d=2))
        out[zero] = {"train_err": metrics["train_err"], "params": _whole(model),
                     "sharded": sorted(model.model_parallel_params),
                     "numel": sum(p.numel() for p in model.parameters()),
                     "state": _flat_state(trainer.optimizer.state_dict())}
    # replicate() on a sharded model: each slice from data rank 0 of its model rank
    held = dict(model.named_parameters())[out[True]["sharded"][0]]
    before = held.detach().clone()
    if mesh.data_rank == 1:
        held.data.add_(1.0)
    mesh_lib.replicate(model, mesh)
    out["replicated_slice"] = torch.equal(held.detach(), before)
    return out


def _case_optimizer(rank, inputs):
    """Each policy on slices of the LEAVES for three steps, and the global
    norm the clip saw at each."""
    from neuraloperator_tpu_torch.parallel import comm

    mesh = mesh_lib.get_mesh()
    group = mesh.model_group
    dims = {k: d for k, (_, d) in LEAVES.items() if d is not None}
    init = _draws(0)
    out = {}
    for policy in POLICIES:
        params = {k: torch.nn.Parameter(comm.own_slice(torch.from_numpy(v), dims[k], group)
                                        if k in dims else torch.from_numpy(v.copy()))
                  for k, v in init.items()}
        opt = _port_transform(policy).bind(list(params.items()), model_parallel=(group, dims))
        norms = []
        for step, scale in enumerate(GRAD_SCALES):
            grads = _draws(100 + step, scale)
            for k, p in params.items():
                g = torch.from_numpy(grads[k])
                p.grad = comm.own_slice(g, dims[k], group) if k in dims else g
            norms.append(float(opt._global_norm()) if opt.max_grad_norm else None)
            opt.step()
        whole = {k: (comm.all_gather_along(p.detach(), dims[k], group) if k in dims
                     else p.detach()).numpy() for k, p in params.items()}
        out[policy] = {"params": whole, "norms": norms,
                       "held": {k: p.numel() for k, p in params.items()},
                       "state": _flat_state(opt.state_dict())}
    return out


def _case_checkpoints(rank, inputs):
    """A trained step's model and optimizer at model size 2 saved through the
    orbax counterparts (synchronous and async) and read back into fresh
    modules; and a msgpack save of the same."""
    from neuraloperator_tpu_torch.training import (
        load_training_state_orbax,
        save_training_state,
        save_training_state_orbax,
    )

    mesh = mesh_lib.get_mesh()
    root = inputs["tmp"]

    def build():
        model = mesh_lib.shard_params(_port(FNO_KW, inputs["params"]["dense"]), mesh)
        opt = _port_transform("factored").bind(model.named_parameters(),
                                               model_parallel=mesh_lib.model_parallel_layout(model))
        return model, opt

    from neuraloperator_tpu_torch.models.base_model import load_checkpoint, save_checkpoint

    model, opt = build()
    x, y = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["y"])
    ((model(x) - y) ** 2).mean().backward()
    opt.step()
    out = {"params": _whole(model), "state": _flat_state(opt.state_dict())}
    save_training_state(root / "msgpack", "model", model, opt.state_dict(), epoch=3)
    save_checkpoint(model, root / "checkpoint", "fno")
    fresh, _ = build()
    load_checkpoint(fresh, root / "checkpoint", "fno")
    out["checkpoint"] = all(torch.equal(v, fresh.state_dict()[k])
                            for k, v in model.state_dict().items())
    for async_save in (False, True):
        path = save_training_state_orbax(root / f"dcp_{async_save}", model, opt, epoch=7,
                                         async_save=async_save)
        fresh, fresh_opt = build()
        params, opt_state, epoch = load_training_state_orbax(path, fresh, fresh_opt)
        out[async_save] = {
            "path": path.name, "epoch": epoch, "opt_is_template": opt_state is fresh_opt,
            "params": all(torch.equal(params[k], v) for k, v in model.state_dict().items()),
            "state": all(torch.equal(fresh_opt.state[q][key], opt.state[p][key])
                         for p, q in zip(opt.param_groups[0]["params"],
                                         fresh_opt.param_groups[0]["params"])
                         for key in opt.state[p]) and int(fresh_opt.count) == int(opt.count)}
    return out


def _galore_run(inputs, mesh, zero, epochs=GALORE_EPOCHS, save_dir=None, resume=None):
    """``epochs`` one-batch epochs of the Trainer with Tensor-GaLore on
    ``mesh``: the last loss, the gathered parameters, the whole state tree,
    this rank's factors as held and the numbers of values this rank holds."""
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.training import Trainer

    model = _port(GALORE_KW, inputs["params"]["galore"])
    trainer = Trainer(model=model, n_epochs=epochs, device="cpu", mesh=mesh, zero_sharding=zero)
    metrics = trainer.train([{"x": inputs["x"], "y": inputs["y"]}], {}, _galore_transform(),
                            training_loss=LpLoss(d=2), save_dir=save_dir,
                            save_every=None if save_dir is None else 1, resume_from_dir=resume)
    opt = trainer.optimizer
    held = {n: (p.numel(), sum(t.numel() for t in [*opt.state[p]["factors"], opt.state[p]["m"],
                                                      opt.state[p]["v"]]))
            for n, p in model.named_parameters()}
    return {"train_err": metrics.get("train_err"), "params": _whole(model),
            "state": _flat_state(opt.state_dict()), "held": held,
            "factors": {f"{n}.{k}": f.numpy().copy() for n, p in model.named_parameters()
                        for k, f in enumerate(opt.state[p]["factors"])},
            "type": type(opt).__name__}


def _case_galore(rank, inputs):
    """Tensor-GaLore through the Trainer on the slices: at (data 1, model 2)
    and under ZeRO at (data 2, model 1) on two ranks; at (1, 4) and under
    ZeRO at (2, 2) on four; a save at model size 2 (or 4) resumed at 4 (or
    2); and ZeroAdamW's refusal of a transform it cannot cut."""
    from neuraloperator_tpu_torch.parallel.zero import ZeroAdamW

    world = torch.distributed.get_world_size()
    mesh = mesh_lib.get_mesh()
    tmp = inputs["tmp"] / f"galore_{world}"
    out = {}
    if world == 2:
        out["model"] = _galore_run(inputs, mesh, False, save_dir=tmp)
        with mesh_lib.use_mesh(None):
            data = mesh_lib.init(model_parallel_size=1, device="cpu")
        out["zero"] = _galore_run(inputs, data, True)
        try:
            ZeroAdamW(_galore_transform(), [("w", torch.nn.Parameter(torch.zeros(2, 2)))], data)
        except ValueError as e:
            out["refused"] = str(e)
    else:
        with mesh_lib.use_mesh(None):
            model4 = mesh_lib.init(model_parallel_size=4, device="cpu")
        out["model"] = _galore_run(inputs, model4, False, save_dir=tmp)
        out["zero"] = _galore_run(inputs, mesh, True)
        # the save at model size 4 resumed at (2, 2) under ZeRO: the state
        # read is the saved tree (no epoch is left, so nothing steps)
        out["resumed"] = _galore_run(inputs, mesh, True, resume=tmp)
    return out


def _galore_steps(mesh, zero):
    """GALORE_EPOCHS steps of rank-7 Tensor-GaLore on GALORE_LEAVES' slices of
    random gradients: the gathered leaves, the whole tree, this rank's
    factors and the numbers of state values it holds."""
    from neuraloperator_tpu_torch.parallel import comm

    group = mesh.model_group
    dims = {k: d for k, (_, d) in GALORE_LEAVES.items()
            if d is not None and mesh.shape[mesh_lib.MODEL_AXIS] > 1}
    params = {k: torch.nn.Parameter(comm.own_slice(torch.from_numpy(v), dims[k], group)
                                    if k in dims else torch.from_numpy(v.copy()))
              for k, v in _galore_draws(0).items()}
    opt = _galore_transform(rank=7).bind(list(params.items()), model_parallel=(group, dims),
                                         zero_group=mesh.data_group if zero else None)
    for step in range(GALORE_EPOCHS):
        for k, g in _galore_draws(100 + step).items():
            g = torch.from_numpy(0.1 * g)
            params[k].grad = comm.own_slice(g, dims[k], group) if k in dims else g
        opt.step()
    return {"params": {k: (comm.all_gather_along(p.detach(), dims[k], group) if k in dims
                           else p.detach()).numpy() for k, p in params.items()},
            "state": _flat_state(opt.state_dict()),
            "factors": {f"{k}.{i}": f.numpy().copy() for k, p in params.items()
                        for i, f in enumerate(opt.state[p]["factors"])},
            "held": sum(t.numel() for p in params.values() for t in
                        [*opt.state[p]["factors"], opt.state[p]["m"], opt.state[p]["v"]])}


def _case_galore_optimizer(rank, inputs):
    """Rank-7 Tensor-GaLore on slices at model size 2 and ZeRO at data size 2
    (two ranks); at model size 4 and ZeRO at (2, 2) (four)."""
    world = torch.distributed.get_world_size()
    with mesh_lib.use_mesh(None):
        other = mesh_lib.init(model_parallel_size=1 if world == 2 else 4, device="cpu")
    mesh = mesh_lib.get_mesh()
    if world == 2:
        return {"model": _galore_steps(mesh, False), "zero": _galore_steps(other, True)}
    return {"model": _galore_steps(other, False), "zero": _galore_steps(mesh, True)}


CASES = {2: ["shards", "trainer", "optimizer", "checkpoints", "galore", "galore_optimizer"],
         4: ["trainer", "galore", "galore_optimizer"]}


def _ranks_main(rank, world, inputs):
    mesh_lib.init(model_parallel_size=2, device="cpu")
    return {name: globals()[f"_case_{name}"](rank, inputs) for name in CASES[world]}


# ------------------------------------------------------------------------ the JAX side


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Each factorization's JAX parameter tree, its leaves drawn from a seeded
    numpy generator at the shapes of the JAX ``init`` (``jax.eval_shape``:
    a traced init, not a run one), and a batch of 8."""
    import jax

    from neuraloperator_tpu.models import FNO as JFNO

    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 1, 8, 8)).astype(np.float32)

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in sorted(tree.items())}
        return (0.3 * rng.standard_normal(tree.shape)).astype(np.float32)

    params = {name: draw(jax.eval_shape(JFNO(**FNO_KW, **kw).init, jax.random.PRNGKey(2),
                                        x)["params"])
              for name, kw in FACTORIZATIONS.items()}
    y = rng.standard_normal((8, 1, 8, 8)).astype(np.float32)
    params["galore"] = draw(jax.eval_shape(JFNO(**GALORE_KW).init, jax.random.PRNGKey(2),
                                           x)["params"])
    return {"params": params, "x": x, "y": y,
            "tmp": tmp_path_factory.mktemp("model_parallel")}


@pytest.fixture(scope="module")
def worlds(inputs):
    """Both groups of ranks, started together (each from its own thread)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        runs = {w: pool.submit(run_ranks, _ranks_main, w, (inputs,), timeout_s=300)
                for w in CASES}
        return {w: run.result() for w, run in runs.items()}


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[2]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[4]


def _leaves(params):
    from neuraloperator_tpu_torch import convert

    return convert.flatten_flax(_numpy_tree(params))


@pytest.mark.parametrize("name", list(FACTORIZATIONS))
def test_shard_then_gather_is_the_whole_tree(world2, inputs, name):
    """Each rank holds half of every leaf JAX shards (SHARDED), the gather
    gives back the whole tree and the cut the slices, to the bit; the
    forward is JAX's."""
    import jax

    from neuraloperator_tpu.models import FNO as JFNO

    kw = dict(FNO_KW, **FACTORIZATIONS[name])
    want = np.asarray(jax.jit(JFNO(**kw).apply)({"params": inputs["params"][name]},
                                                 inputs["x"]))
    names, want_dim = SHARDED[name]
    whole = _leaves(inputs["params"][name])
    for got in world2:
        got = got["shards"][name]
        assert sorted(got["sharded"]) == names
        for key, (dim, shape, held) in got["sharded"].items():
            assert shape == whole[key].shape and 2 * held == whole[key].size
            assert dim == want_dim
        assert got["equal"] and got["cut"]
        np.testing.assert_allclose(got["forward"], want, **FORWARD_TOL)


@pytest.fixture(scope="module")
def jax_step(inputs):
    """One optax AdamW step of the JAX FNO on the 8 rows: loss, parameters."""
    import jax
    import optax

    from neuraloperator_tpu.losses import LpLoss as JLp
    from neuraloperator_tpu.models import FNO as JFNO

    model, l2, opt = JFNO(**FNO_KW), JLp(d=2), optax.adamw(1e-3)

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(
            lambda q: l2(model.apply({"params": q}, inputs["x"]), inputs["y"]))(p)
        updates, _ = opt.update(grads, opt.init(p), p)
        return loss, optax.apply_updates(p, updates)

    loss, params = step(inputs["params"]["dense"])
    return float(loss), _leaves(params)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("zero", [False, True])
def test_trainer_step_on_slices_matches_jax(world2, world4, jax_step, world, zero):
    """A Trainer step at (data 1, model 2) and (data 2, model 2), replicated
    and under ZeRO: the loss and every gathered parameter are JAX's, each
    rank holds the spectral weights' slices alone, and ZeRO's state, cut
    over both groups, gathers to the replicated run's whole optax tree."""
    loss, want = jax_step
    whole = sum(v.size for v in want.values())
    spectral = sum(v.size for k, v in want.items() if k.endswith("w_weight"))
    for got in (world2 if world == 2 else world4):
        # replicate() of the sharded model hands each slice on from data rank 0
        assert got["trainer"]["replicated_slice"]
        run = got["trainer"][zero]
        assert run["sharded"] == ["fno_blocks.conv_0.w_weight", "fno_blocks.conv_1.w_weight"]
        assert run["numel"] == whole - spectral // 2
        np.testing.assert_allclose(run["train_err"], loss, rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(run["params"][name], w, **STEP_TOL, err_msg=name)
        replicated = got["trainer"][False]["state"]
        assert set(run["state"]) == set(replicated)
        for k, v in replicated.items():
            np.testing.assert_allclose(run["state"][k], v, rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_adamw_on_slices_matches_optax(world2, policy):
    """Full (clipped by the global norm), factored and factored8 AdamW on
    slices of the TFNO layouts: the gathered parameters after three steps
    are optax's on the whole leaves, the clip saw the whole norm, and the
    int8 first moment stays whole (its blocks straddle the slices)."""
    import jax
    import jax.numpy as jnp
    import optax

    tx = _jax_transform(policy)
    params = {k: jnp.asarray(v) for k, v in _draws(0).items()}
    state = tx.init(params)
    update = jax.jit(tx.update)
    norms = []
    for step, scale in enumerate(GRAD_SCALES):
        grads = _draws(100 + step, scale)
        norms.append(float(np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                                       for g in grads.values()))))
        updates, state = update({k: jnp.asarray(g) for k, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
    # the global norm and the factored means over a sliced dim are summed
    # per slice, then over the group: the clip's scale and the second moment
    # may move an ulp (the f32 bound of tests/test_torch_training_extras.py's
    # max_grad_norm runs); a bf16 first moment keeps its rounding bound
    atol = 2.0 ** -8 * LR * len(GRAD_SCALES) if policy == "factored" else 1e-8
    for got in world2:
        got = got["optimizer"][policy]
        for k, w in params.items():
            np.testing.assert_allclose(got["params"][k], np.asarray(w), rtol=1e-6, atol=atol,
                                       err_msg=k)
            shape, dim = LEAVES[k]
            assert got["held"][k] * (1 if dim is None else 2) == np.prod(shape)
        if policy == "full":
            assert [n > MAX_GRAD_NORM for n in norms] == [True, False, True]
            np.testing.assert_allclose(got["norms"], norms, rtol=1e-6)
        if policy == "factored8":
            # every leaf of two or more dims: one block of the whole leaf
            codes = {k: v for k, v in got["state"].items() if k.endswith(".codes")}
            assert len(codes) == 5 and all(v.size == 2048 for v in codes.values())


def test_dcp_checkpoint_roundtrip(world2, inputs):
    """The orbax counterparts at model size 2, synchronous and async (the
    JAX test's round trip): fresh modules read back every slice, the
    optimizer's state and the epoch to the bit. The same save read in a
    world of one (no process group) into whole modules equals the gathered
    tree, and JAX's own orbax round trip of those parameters gives the same
    values."""
    import jax.numpy as jnp

    from neuraloperator_tpu.training import training_state as jts
    from neuraloperator_tpu_torch import convert
    from neuraloperator_tpu_torch.training import (
        load_training_state_orbax,
        save_training_state_orbax,
    )

    for got in world2:
        got = got["checkpoints"]
        for async_save in (False, True):
            run = got[async_save]
            assert run["path"] == "orbax" and run["epoch"] == 7
            assert run["params"] and run["state"] and run["opt_is_template"]
    want = world2[0]["checkpoints"]
    for async_save in (False, True):
        model = _port(FNO_KW, inputs["params"]["dense"])
        opt = _port_transform("factored").bind(model.named_parameters())
        params, opt_state, epoch = load_training_state_orbax(
            inputs["tmp"] / f"dcp_{async_save}", model, opt)
        assert epoch == 7 and opt_state is opt
        for k, v in want["params"].items():
            np.testing.assert_array_equal(params[k].numpy(), v, err_msg=k)
        got_state = _flat_state(opt.state_dict())
        assert set(got_state) == set(want["state"])
        for k, v in want["state"].items():
            np.testing.assert_array_equal(got_state[k], v, err_msg=k)
    # a state_dict and an optax tree as the templates: read into new tensors,
    # and an optax tree saved as the optimizer state
    whole, _, _ = load_training_state_orbax(inputs["tmp"] / "dcp_False", model.state_dict())
    for k, v in want["params"].items():
        np.testing.assert_array_equal(whole[k].numpy(), v, err_msg=k)
    save_training_state_orbax(inputs["tmp"] / "tree", model.state_dict(), opt.state_dict())
    _, tree_state, tree_epoch = load_training_state_orbax(inputs["tmp"] / "tree",
                                                          model.state_dict(), opt.state_dict())
    assert tree_epoch is None
    for k, v in _flat_state(tree_state).items():
        np.testing.assert_array_equal(v, want["state"][k], err_msg=k)
    tree = convert.unflatten_flax({k: jnp.asarray(v) for k, v in want["params"].items()})
    jts.save_training_state_orbax(inputs["tmp"] / "jax", tree, epoch=7)
    jp, _, jepoch = jts.load_training_state_orbax(
        inputs["tmp"] / "jax", convert.unflatten_flax(
            {k: jnp.zeros_like(v) for k, v in convert.flatten_flax(tree).items()}))
    assert jepoch == 7
    for k, v in _leaves(jp).items():
        np.testing.assert_array_equal(v, params[k].numpy(), err_msg=k)


def test_msgpack_save_at_model_size_two_reads_in_jax(world2, inputs):
    """``save_training_state`` of the sharded model writes the whole tree
    from rank 0: JAX's ``load_training_state`` reads the parameters and the
    optax state to the bit; ``save_checkpoint`` writes the whole weights,
    which ``load_checkpoint`` cuts to a fresh sharded model's slices and
    reads whole into a model in one process."""
    from neuraloperator_tpu_torch.models.base_model import load_checkpoint
    import flax.serialization

    from neuraloperator_tpu.training import training_state as jts

    want = world2[0]["checkpoints"]
    params = inputs["params"]["dense"]
    tx = _jax_transform("factored")
    jparams, jstate, epoch = jts.load_training_state(inputs["tmp"] / "msgpack", "model",
                                                     params, tx.init(params))
    assert epoch == 3
    for k, v in _leaves(jparams).items():
        np.testing.assert_array_equal(v, want["params"][k], err_msg=k)
    got = _flat_state(_numpy_tree(flax.serialization.to_state_dict(jstate)))
    assert set(got) == set(want["state"])
    for k, v in want["state"].items():
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), v, err_msg=k)
    assert all(r["checkpoints"]["checkpoint"] for r in world2)
    model = load_checkpoint(_port(FNO_KW, inputs["params"]["dense"]), inputs["tmp"] / "checkpoint",
                            "fno")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want["params"][k], err_msg=k)


# ------------------------------------------------------------- Tensor-GaLore on slices


def _update_errors(got: dict, want: dict, start: dict) -> dict:
    """Each leaf's change from ``start`` against JAX's, relative to the larger
    of the change's norm and 1% of the whole change's (``chip_smoke.py``'s
    ``grad_errors``)."""
    total = np.sqrt(sum(np.square(want[k] - start[k]).sum() for k in want))
    return {k: float(np.linalg.norm(got[k] - want[k]))
            / max(float(np.linalg.norm(want[k] - start[k])), 1e-2 * total) for k in want}


@pytest.fixture(scope="module")
def jax_galore(inputs):
    """The JAX Trainer with Tensor-GaLore (its factors sign-fixed as the port
    fixes them) for GALORE_EPOCHS one-batch epochs on its 8 fake devices, at
    model size 2 and at model size 4 under ZeRO: the last loss, the
    parameters and the state tree."""
    import flax.serialization

    from neuraloperator_tpu.losses import LpLoss as JLp
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.training import Trainer as JTrainer
    from neuraloperator_tpu.training import tensor_galore as jgal

    from test_torch_training_extras import _sign_fixed_jax_hosvd

    loader = [{"x": inputs["x"], "y": inputs["y"]}]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _sign_fixed_jax_hosvd(mp)
        for size, zero in ((2, False), (4, True)):
            trainer = JTrainer(model=JFNO(**GALORE_KW), n_epochs=GALORE_EPOCHS,
                               mesh=jmesh.init(model_parallel_size=size), zero_sharding=zero)
            trainer.params = inputs["params"]["galore"]
            metrics = trainer.train(loader, {}, jgal.tensor_galore_adamw(GALORE_LR, **GALORE),
                                    training_loss=JLp(d=2))
            out[size] = {"train_err": metrics["train_err"], "params": _leaves(trainer.params),
                         "state": _flat_state(_numpy_tree(
                             flax.serialization.to_state_dict(trainer.opt_state)))}
    return out


# each leaf's update within 1e-3 of JAX's, against the larger of its norm and
# 1% of the whole update's (PERF.md's bound for GaLore's update, card against
# CPU): a model rank sums its slice's core in another order, and a data rank
# its slice of the batch
GALORE_UPDATE_TOL = 1e-3


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("zero", [False, True])
def test_tensor_galore_on_slices_matches_jax(world2, world4, jax_galore, inputs, world, zero):
    """Tensor-GaLore through the Trainer over three steps with refreshes at 1
    and 3: at model size 2 (world 2) and 4 (world 4), and under ZeRO at
    data size 2 (world 2) and at (2, 2) (world 4). The loss and each leaf's
    update are JAX's; the state tree is the JAX ``GaLoreState``, its factors
    JAX's (sign-fixed) and whole; on the model axis each rank holds its
    slices alone and the same factors as every other rank, and under ZeRO
    each rank holds its cut of the state."""
    ranks = world2 if world == 2 else world4
    runs = [got["galore"]["zero" if zero else "model"] for got in ranks]
    ref = jax_galore[2 if world == 2 and not zero or world == 4 and zero else 4]
    start = _leaves(inputs["params"]["galore"])
    size = 1 if world == 2 and zero else 2 if world == 4 and zero else world
    for run in runs:
        assert run["type"] == "TensorGaLoreAdamW"
        np.testing.assert_allclose(run["train_err"], ref["train_err"], rtol=1e-5)
        errors = _update_errors(run["params"], ref["params"], start)
        worst = max(errors, key=errors.get)
        assert errors[worst] <= GALORE_UPDATE_TOL, sorted(errors.items(), key=lambda e: -e[1])
        assert set(run["state"]) == set(ref["state"])
        for k, v in ref["state"].items():
            assert run["state"][k].shape == v.shape, k
            if ".factors." in k:  # orthonormal columns: 1e-5 of 1
                np.testing.assert_allclose(run["state"][k], v, rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(run["state"]["count"], GALORE_EPOCHS)
        for name, (numel, state) in run["held"].items():
            sliced = name.endswith("w_weight") and size > 1
            assert numel * (size if sliced else 1) == start[name].size, name
        # every rank's whole tree is the same, to the bit
        for k, v in runs[0]["state"].items():
            np.testing.assert_array_equal(run["state"][k], v, err_msg=k)
    whole = sum(v.size for k, v in ref["state"].items() if k != "count")
    held = [sum(s for _, s in run["held"].values()) for run in runs]
    if zero:
        assert max(held) < whole
    else:  # the factors and the core moments replicated over the model group
        for run in runs:
            for k, f in run["factors"].items():
                np.testing.assert_array_equal(f, runs[0]["factors"][k], err_msg=k)
        assert held == [whole] * len(runs)


def test_zero_refuses_a_transform_it_cannot_cut(world2):
    """``ZeroAdamW`` given ``tensor_galore_adamw(...)`` raises a ValueError that
    names it (it used to fail inside AdamW with a TypeError on ``rank``); the
    Trainer's ZeRO binds Tensor-GaLore with its state cut instead (the test
    above)."""
    for got in world2:
        assert "TensorGaLoreTransform" in got["galore"]["refused"]


def test_tensor_galore_saves_at_one_model_size_and_resumes_at_another(world2, world4, inputs):
    """The state saved at model size 4 resumes at (data 2, model 2) under
    ZeRO: the parameters and the whole tree to the bit. The save at model
    size 2 is the JAX package's ``GaLoreState``: JAX's
    ``load_training_state`` reads it to the bit."""
    import flax.serialization

    from neuraloperator_tpu.training import tensor_galore as jgal
    from neuraloperator_tpu.training import training_state as jts

    for got in world4:
        saved, resumed = got["galore"]["model"], got["galore"]["resumed"]
        assert resumed["train_err"] is None  # no epoch left to train
        for k, v in saved["params"].items():
            np.testing.assert_array_equal(resumed["params"][k], v, err_msg=k)
        assert set(resumed["state"]) == set(saved["state"])
        for k, v in saved["state"].items():
            np.testing.assert_array_equal(resumed["state"][k], v, err_msg=k)
    want = world2[0]["galore"]["model"]
    params = inputs["params"]["galore"]
    tx = jgal.tensor_galore_adamw(GALORE_LR, **GALORE)
    jparams, jstate, epoch = jts.load_training_state(inputs["tmp"] / "galore_2", "model",
                                                     params, tx.init(params))
    assert epoch == GALORE_EPOCHS - 1
    for k, v in _leaves(jparams).items():
        np.testing.assert_array_equal(v, want["params"][k], err_msg=k)
    got = _flat_state(_numpy_tree(flax.serialization.to_state_dict(jstate)))
    assert set(got) == set(want["state"])
    for k, v in want["state"].items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("zero", [False, True])
def test_tensor_galore_optimizer_on_slices_matches_jax(monkeypatch, world2, world4, world, zero):
    """Rank-7 Tensor-GaLore over three steps of random gradients (refreshes at
    1 and 3) at model size 2 (world 2) and 4 (world 4), and under ZeRO at
    data size 2 (world 2) and at (2, 2) (world 4), against JAX's
    transformation on the whole leaves with its factors sign-fixed: the
    parameters within ``atol=1e-6`` (the bound of
    ``tests/test_torch_training_extras.py::test_tensor_galore_matches_jax``),
    the whole factors within 1e-5, the tree JAX's; on the model axis every
    rank holds the same factors, under ZeRO less state than the whole."""
    import flax.serialization
    import jax.numpy as jnp
    import optax

    from neuraloperator_tpu.training import tensor_galore as jgal

    from test_torch_training_extras import _sign_fixed_jax_hosvd

    _sign_fixed_jax_hosvd(monkeypatch)
    tx = jgal.tensor_galore_adamw(GALORE_LR, **{**GALORE, "rank": 7})
    params = {k: jnp.asarray(v) for k, v in _galore_draws(0).items()}
    state = tx.init(params)
    for step in range(GALORE_EPOCHS):
        grads = {k: jnp.asarray(0.1 * g) for k, g in _galore_draws(100 + step).items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    want = _flat_state(_numpy_tree(flax.serialization.to_state_dict(state)))
    runs = [got["galore_optimizer"]["zero" if zero else "model"]
            for got in (world2 if world == 2 else world4)]
    for run in runs:
        for k, w in params.items():
            np.testing.assert_allclose(run["params"][k], np.asarray(w), rtol=0, atol=1e-6,
                                       err_msg=k)
        assert set(run["state"]) == set(want)
        for k, w in want.items():
            assert run["state"][k].shape == w.shape, k
            if ".factors." in k:  # see the docstring
                np.testing.assert_allclose(run["state"][k], w, rtol=0, atol=1e-4, err_msg=k)
    whole = sum(v.size for k, v in want.items() if k != "count")
    if zero:
        assert all(run["held"] < whole for run in runs)
    else:
        for run in runs:
            for k, f in run["factors"].items():
                np.testing.assert_array_equal(f, runs[0]["factors"][k], err_msg=k)
