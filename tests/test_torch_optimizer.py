"""The port's AdamW (full and factored), step_lr and StepLR against the JAX package's.

Both optimizers start from the same parameters and are fed the same
gradients (numpy, seeded) for three steps, across a ``step_lr`` boundary
(step size 1 epoch of 2 steps). Leaves cover the ranks the flagship has: a
5-d spectral weight (2, I, O, m1, m2), 2-d channel-MLP weights, 1-d biases
and a scalar-like (1,) leaf.

Tolerances: the "full" policy (f32 moments): parameters after each step
``rtol=1e-6, atol=1e-9`` (the same f32 arithmetic in optax's order, the
bias corrections ``1 - b ** count`` formed in f32 on both sides; torch's
and XLA's kernels may still round a few elements 1 ulp apart). The
"factored" policy stores mu in bf16:
where the f32 moment lands within an ulp of a bf16 rounding boundary, the
two sides may round mu one bf16 ulp (2**-8 relative) apart, which moves
that element's update by up to 2**-8 of one step (lr 1e-2 here), so
parameters are held to ``atol=2**-8 * 1e-2 * 3`` over three steps; the
first moments to one bf16 ulp, the factored second moments (always f32) to
``rtol=1e-6``.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuraloperator_tpu.training import optimizer as jopt
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.training import optimizer as topt

torch.set_num_threads(1)

SHAPES = {
    "conv.w_weight": (2, 3, 4, 6, 5),
    "mlp.w0": (7, 3),
    "mlp.b0": (7,),
    "gate.weight": (1,),
}
STEPS_PER_EPOCH = 2


def _tree(flat):
    tree = {}
    for name, leaf in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _draws(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _run_both(tx_jax, transform, n_steps=3, lr_scale=1.0):
    init = _draws(0)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = transform.bind(params.values())
    j_params = _tree({k: jnp.asarray(v) for k, v in init.items()})
    j_state = tx_jax.init(j_params)
    history = []
    for step in range(n_steps):
        grads = _draws(100 + step, scale=0.1 * (step + 1))
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step(lr_scale=lr_scale)
        updates, j_state = tx_jax.update(_tree(grads), j_state, j_params)
        updates = jax.tree_util.tree_map(
            lambda u: (u.astype(jnp.float32) * jnp.float32(lr_scale)).astype(u.dtype), updates)
        j_params = optax.apply_updates(j_params, updates)
        history.append((
            {k: p.detach().numpy().copy() for k, p in params.items()},
            {k: np.asarray(v) for k, v in convert.flatten_flax(j_params).items()},
        ))
    return history, opt, j_state


def _schedule():
    return dict(learning_rate=1e-2, step_size=1, gamma=0.5, weight_decay=1e-2)


@pytest.mark.parametrize("lr_scale", [1.0, 0.3])
def test_adamw_full_matches_optax(lr_scale):
    cfg = SimpleNamespace(**_schedule(), opt_state="full")
    history, opt, _ = _run_both(
        jopt.build_optimizer(cfg, STEPS_PER_EPOCH),
        topt.build_optimizer(cfg, STEPS_PER_EPOCH), lr_scale=lr_scale,
    )
    assert opt.count == 3 and not opt.factored and opt.mu_dtype is None
    for port, ref in history:
        for k in SHAPES:
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("lr_scale", [1.0, 0.3])
def test_adamw_factored_matches_optax(lr_scale):
    cfg = SimpleNamespace(**_schedule(), opt_state="factored")
    history, opt, j_state = _run_both(
        jopt.build_optimizer(cfg, STEPS_PER_EPOCH),
        topt.build_optimizer(cfg, STEPS_PER_EPOCH), lr_scale=lr_scale,
    )
    atol = 2.0 ** -8 * 1e-2 * 3
    for port, ref in history:
        for k in SHAPES:
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=atol, err_msg=k)
    # the state: bf16 mu, f32 factored nu over the last two axes, full nu below 2-d
    adam = j_state[0]  # the chain's first state: scale_by_adam_factored's
    j_mu, j_row, j_col, j_full = (convert.flatten_flax(t) for t in (
        adam.mu, adam.nu_row, adam.nu_col, adam.nu_full))
    params = dict(zip(SHAPES, opt.param_groups[0]["params"]))
    for k, p in params.items():
        st = opt.state[p]
        assert st["mu"].dtype == torch.bfloat16
        np.testing.assert_allclose(st["mu"].float().numpy(), np.asarray(j_mu[k], np.float32),
                                   rtol=2.0 ** -8, atol=0, err_msg=k)
        if len(SHAPES[k]) >= 2:
            assert st["nu_row"].shape == SHAPES[k][:-1]
            assert st["nu_col"].shape == SHAPES[k][:-2] + SHAPES[k][-1:]
            np.testing.assert_allclose(st["nu_row"].numpy(), j_row[k], rtol=1e-6)
            np.testing.assert_allclose(st["nu_col"].numpy(), j_col[k], rtol=1e-6)
        else:
            assert st["nu"].dtype == torch.float32
            np.testing.assert_allclose(st["nu"].numpy(), j_full[k], rtol=1e-6)


def test_step_lr_matches_optax_schedule():
    port = topt.step_lr(3e-5, 50, 0.5, steps_per_epoch=7)
    ref = jopt.step_lr(3e-5, 50, 0.5, steps_per_epoch=7)
    for count in (0, 1, 349, 350, 351, 700, 1049, 1050, 5000):
        np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6)
    with pytest.raises(ValueError):
        topt.step_lr(1e-3, 0)


def test_step_lr_scheduler_protocol():
    port, ref = topt.StepLR(step_size=2, gamma=0.3), jopt.StepLR(step_size=2, gamma=0.3)
    for _ in range(5):
        port.step()
        ref.step()
        assert port.factor == ref.factor and port.epoch == ref.epoch
    state = port.state_dict()
    fresh = topt.StepLR(step_size=2, gamma=0.3)
    fresh.load_state_dict(state)
    assert fresh.factor == port.factor and fresh.epoch == port.epoch
    assert port.needs_metric is False


def test_adamw_with_a_constant_rate_and_defaults():
    """``adamw`` with a float rate and no weight decay, fed to the same harness."""
    history, _, _ = _run_both(jopt.adamw(1e-3), topt.adamw(1e-3), n_steps=2)
    for port, ref in history:
        for k in SHAPES:
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, atol=1e-9, err_msg=k)


def test_parameters_without_gradients_are_left_alone():
    """No parameter is skipped: one without a gradient takes a zero gradient,
    so at the first step only weight decay moves it (Adam's direction is 0)."""
    p, q = torch.nn.Parameter(torch.ones(3, 2)), torch.nn.Parameter(torch.ones(2))
    opt = topt.adamw(1e-1, weight_decay=0.5).bind([p, q])
    p.grad = torch.ones(3, 2)
    opt.step()
    assert not torch.equal(p.detach(), torch.ones(3, 2))
    assert q in opt.state and q.grad is None
    torch.testing.assert_close(q.detach(), torch.full((2,), 1 - 1e-1 * 0.5), rtol=1e-6, atol=0)


@pytest.mark.parametrize("policy", ["full", "factored"])
def test_parameter_outside_the_loss_moves_like_optax(policy):
    """A parameter that never gets a gradient (``.grad`` None in the port, a
    zero leaf in optax) is still decayed by optax's AdamW: lr 1e-2, weight
    decay 0.1, 3 steps take 2.0 to 1.99401. Held at the "full" tolerance
    of this file; the unused leaf's moments stay exactly zero on both sides."""
    cfg = SimpleNamespace(learning_rate=1e-2, step_size=1000, gamma=0.5, weight_decay=0.1,
                          opt_state=policy)
    init = {"used": np.array([0.5, -1.5, 2.5], np.float32), "unused": np.full((2, 3), 2.0, np.float32)}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = topt.build_optimizer(cfg).bind(params.values())
    tx = jopt.build_optimizer(cfg)
    j_params = {k: jnp.asarray(v) for k, v in init.items()}
    j_state = tx.init(j_params)
    rng = np.random.default_rng(7)
    for _ in range(3):
        g = rng.standard_normal(3).astype(np.float32)
        params["used"].grad = torch.from_numpy(g)
        params["unused"].grad = None
        opt.step()
        updates, j_state = tx.update(
            {"used": jnp.asarray(g), "unused": jnp.zeros((2, 3), jnp.float32)}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
    for k in init:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(j_params[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(params["unused"].detach().numpy(), 1.99401, rtol=1e-5)


def test_unported_options_raise():
    base = dict(learning_rate=1e-3, step_size=10, weight_decay=0.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.build_optimizer(SimpleNamespace(**base, opt_state="factored8"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.build_optimizer(SimpleNamespace(**base, opt_state="full", ema_decay=0.99))
    with pytest.raises(ValueError):
        topt.build_optimizer(SimpleNamespace(**base, opt_state="other"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.adamw(1e-3, max_grad_norm=1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        topt.adamw(1e-3, factored_second_moment=True, mu_dtype="int8")
