"""The sharded-FFT spectral convolution, the halo exchange and the
model-parallel multigrid patching at gloo world size 4 on the CPU, against
the JAX package on its 8 fake CPU devices (the cases of
``tests/test_distributed_fft.py``).

The JAX functions run at model size 4, as the port's group; the halo
exchange, which JAX's test runs over 8 devices, runs over 4 ranks on both
sides. Tolerances are JAX's own: 2-D forwards at ``rtol=2e-4, atol=1e-5``,
3-D forwards at 3e-4 / 3e-5 (the FNO-3D at 2e-4 / 2e-4), the 3-D weight
gradient at 2e-3 / 2e-3 and the FNO's gradients at 5e-4 / 5e-5. The 2-D
weight gradient, which JAX's test only finds finite and nonzero, is held
to JAX's at the 3-D bound. One group of spawned ranks runs every case; the
JAX side runs in the test process.
"""

import numpy as np
import pytest
import torch

from neuraloperator_tpu_torch.parallel import mesh as mesh_lib
from neuraloperator_tpu_torch.parallel.launch import run_ranks

torch.set_num_threads(1)

WORLD = 4
FNO2_KW = dict(n_modes=(8, 8), in_channels=1, out_channels=1, hidden_channels=4, n_layers=2)
FNO3_KW = dict(n_modes=(4, 4, 4), in_channels=1, out_channels=1, hidden_channels=4,
               n_layers=2)
CASES_3D = [(4, 4, 3), (5, 6, 4)]


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _leaves(params):
    from neuraloperator_tpu_torch import convert

    return convert.flatten_flax(_numpy_tree(params))


def _fno(kwargs, params, conv):
    from neuraloperator_tpu_torch import convert
    from neuraloperator_tpu_torch.models import FNO
    from neuraloperator_tpu_torch.parallel import distributed_fft as dfft

    model = FNO(**kwargs, conv_module=getattr(dfft, conv), device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return model


# --------------------------------------------------------------------------- the ranks


def _case_conv2d(rank, inputs):
    from neuraloperator_tpu_torch.parallel import distributed_fft as dfft

    mesh = mesh_lib.init(model_parallel_size=WORLD, device="cpu")
    x, w = inputs["conv2d"]
    out = dfft.distributed_spectral_conv2d(torch.from_numpy(x), torch.from_numpy(w), (8, 5),
                                           mesh)
    x, w_st = inputs["grad2d"]
    w_st = torch.from_numpy(w_st).requires_grad_()
    y = dfft.distributed_spectral_conv2d(torch.from_numpy(x), (w_st[0], w_st[1]), (4, 3), mesh)
    (y ** 2).sum().backward()
    return {"out": out.numpy(), "grad": w_st.grad.numpy()}


def _case_conv3d(rank, inputs):
    from neuraloperator_tpu_torch.parallel import distributed_fft as dfft

    mesh = mesh_lib.init(model_parallel_size=WORLD, device="cpu")
    out = {}
    for modes in CASES_3D:
        x, w = inputs["conv3d"][modes]
        out[modes] = dfft.distributed_spectral_conv3d(torch.from_numpy(x), torch.from_numpy(w),
                                                      modes, mesh).numpy()
    x, w_st = inputs["grad3d"]
    w_st = torch.from_numpy(w_st).requires_grad_()
    y = dfft.distributed_spectral_conv3d(torch.from_numpy(x), (w_st[0], w_st[1]), (3, 4, 2),
                                         mesh)
    (y ** 2).sum().backward()
    out["grad"] = w_st.grad.numpy()
    return out


def _case_halo(rank, inputs):
    from neuraloperator_tpu_torch.parallel import distributed_fft as dfft

    mesh = mesh_lib.init(model_parallel_size=WORLD, device="cpu")
    x, w = inputs["halo"]
    rows = x.shape[2] // WORLD
    local = torch.from_numpy(x[:, :, rank * rows:(rank + 1) * rows]).requires_grad_()
    out = dfft.halo_exchange(local, halo=1, group=mesh.model_group)
    weight = torch.from_numpy(w[:, :, rank * (rows + 2):(rank + 1) * (rows + 2)])
    (out * weight).sum().backward()
    return {"out": out.detach().numpy(), "grad": local.grad.numpy()}


def _case_fno(rank, inputs):
    """FNO(conv_module=DistributedSpectralConv2d/3d) on the model group: the
    2-D forward and one loss's gradients, the 3-D forward."""
    from neuraloperator_tpu_torch.losses import LpLoss

    mesh = mesh_lib.init(model_parallel_size=WORLD, device="cpu")
    model = _fno(FNO2_KW, inputs["fno2"], "DistributedSpectralConv2d")
    x, y = (torch.from_numpy(a) for a in inputs["xy2"])
    with torch.no_grad():
        out2 = model(x).numpy()
    LpLoss(d=2)(model(x), y).backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    model3 = _fno(FNO3_KW, inputs["fno3"], "DistributedSpectralConv3d")
    with torch.no_grad():
        out3 = model3(torch.from_numpy(inputs["x3"])).numpy()
    return {"out2": out2, "grads": grads, "out3": out3}


def _case_patching(rank, inputs):
    """One Trainer step of a multigrid-patched FNO with the patches
    scattered over the model ranks (2 x 2: data x model), stitched and not."""
    from neuraloperator_tpu_torch.data.transforms import MGPatchingDataProcessor
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.models import FNO
    from neuraloperator_tpu_torch.training import Trainer, adamw

    mesh = mesh_lib.init(model_parallel_size=2, device="cpu")
    out = {}
    for stitching in (True, False):
        torch.manual_seed(0)
        model = FNO(n_modes=(4, 4), in_channels=2, out_channels=1, hidden_channels=8,
                    n_layers=2, device="cpu")
        processor = MGPatchingDataProcessor(levels=1, padding_fraction=0.125,
                                            stitching=stitching, use_distributed=True,
                                            mesh=mesh)
        trainer = Trainer(model=model, n_epochs=1, device="cpu", mesh=mesh,
                          data_processor=processor)
        loader = [{"x": inputs["patch_x"], "y": inputs["patch_y"]}]
        metrics = trainer.train(loader, {"test": loader}, adamw(1e-3),
                                training_loss=LpLoss(d=2), eval_losses={"l2": LpLoss(d=2)})
        out[stitching] = (metrics, {n: p.detach().numpy().copy()
                                    for n, p in model.named_parameters()},
                          processor.patcher.splits_over_model)
    return out


CASES = ["conv2d", "conv3d", "halo", "fno", "patching"]


def _ranks_main(rank, world, inputs):
    return {name: globals()[f"_case_{name}"](rank, inputs) for name in CASES}


# ------------------------------------------------------------------------ the JAX side


@pytest.fixture(scope="module")
def inputs():
    import jax

    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.distributed_fft import (
        DistributedSpectralConv2d as J2,
        DistributedSpectralConv3d as J3,
    )

    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    w = (rng.randn(3, 4, 8, 5) + 1j * rng.randn(3, 4, 8, 5)).astype(np.complex64)
    rng = np.random.RandomState(1)
    xg = rng.randn(1, 2, 8, 8).astype(np.float32)
    wg = rng.randn(2, 2, 4, 3) + 1j * rng.randn(2, 2, 4, 3)
    wg_st = np.stack([wg.real, wg.imag]).astype(np.float32)
    conv3d = {}
    for kd, kh, kw in CASES_3D:
        rng = np.random.RandomState(0)
        x3 = rng.randn(2, 2, 8, 8, 10).astype(np.float32)
        w3 = (rng.randn(2, 3, kd, kh, kw) + 1j * rng.randn(2, 3, kd, kh, kw)).astype(
            np.complex64)
        conv3d[(kd, kh, kw)] = (x3, w3)
    rng = np.random.RandomState(1)
    xg3 = rng.randn(1, 2, 4, 8, 6).astype(np.float32)
    wg3 = rng.randn(2, 2, 2, 3, 4, 2).astype(np.float32)
    jmesh._CURRENT_MESH = None
    x2 = np.random.RandomState(0).randn(4, 1, 16, 16).astype(np.float32)
    fno2 = JFNO(**FNO2_KW, conv_module=J2).init(jax.random.PRNGKey(0), x2)["params"]
    x3 = np.random.RandomState(0).randn(2, 1, 8, 8, 8).astype(np.float32)
    fno3 = JFNO(**FNO3_KW, conv_module=J3).init(jax.random.PRNGKey(0), x3)["params"]
    return {"conv2d": (x, w), "grad2d": (xg, wg_st), "conv3d": conv3d,
            "grad3d": (xg3, wg3),
            "halo": (np.arange(8 * 4, dtype=np.float32).reshape(1, 1, 8, 4),
                     _rand(2, 1, 1, 16, 4)),
            "fno2": _numpy_tree(fno2), "xy2": (x2, np.random.RandomState(1).randn(
                4, 1, 16, 16).astype(np.float32)),
            "fno3": _numpy_tree(fno3), "x3": x3,
            "patch_x": _rand(3, 4, 1, 16, 16), "patch_y": _rand(4, 4, 1, 16, 16)}


@pytest.fixture(scope="module")
def world(inputs):
    return run_ranks(_ranks_main, WORLD, (inputs,), timeout_s=300)


def _jax_mesh(model_parallel_size):
    from neuraloperator_tpu.parallel import mesh as jmesh

    return jmesh.init(model_parallel_size=model_parallel_size)


def test_distributed_matches_single_device(world, inputs):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from neuraloperator_tpu.parallel.distributed_fft import distributed_spectral_conv2d

    x, w = inputs["conv2d"]
    mesh = _jax_mesh(4)
    with mesh:
        xs = jax.device_put(x, NamedSharding(mesh, P(None, None, "model", None)))
        want = np.asarray(jax.jit(lambda v: distributed_spectral_conv2d(
            v, w, (8, 5), mesh, axis_name="model"))(xs))
    for got in world:
        np.testing.assert_allclose(got["conv2d"]["out"], want, rtol=2e-4, atol=1e-5)


def test_distributed_gradients_flow(world, inputs):
    import jax
    import jax.numpy as jnp

    from neuraloperator_tpu.parallel.distributed_fft import distributed_spectral_conv2d

    x, w_st = inputs["grad2d"]
    mesh = _jax_mesh(4)

    def loss(w_st, x):
        w = jax.lax.complex(w_st[0], w_st[1])
        return jnp.sum(distributed_spectral_conv2d(x, w, (4, 3), mesh, "model") ** 2)

    with mesh:
        want = np.asarray(jax.jit(jax.grad(loss))(w_st, x))
    assert np.all(np.isfinite(want)) and np.any(want != 0)
    for got in world:
        np.testing.assert_allclose(got["conv2d"]["grad"], want, rtol=2e-3, atol=2e-3)


def test_halo_exchange(world, inputs):
    """Each rank's 2 rows become 4: [previous rank's last, own, next rank's
    first] (circular), and the gradient goes back to the rows it came from;
    against JAX's ``ppermute`` ring over 4 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from neuraloperator_tpu.parallel.distributed_fft import halo_exchange

    x, w = inputs["halo"]
    mesh = _jax_mesh(4)
    with mesh:
        fn = jax.shard_map(lambda v: halo_exchange(v, halo=1, axis_name="model"), mesh=mesh,
                           in_specs=P(None, None, "model", None),
                           out_specs=P(None, None, "model", None))
        want = np.asarray(fn(jnp.asarray(x)))
        grad = np.asarray(jax.grad(lambda v: jnp.sum(fn(v) * w))(jnp.asarray(x)))
    assert want.shape == (1, 1, 16, 4)
    got = np.concatenate([r["halo"]["out"] for r in world], axis=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0, 0], x[0, 0, 7])  # the wrap
    got_grad = np.concatenate([r["halo"]["grad"] for r in world], axis=2)
    np.testing.assert_allclose(got_grad, grad, rtol=1e-6)


def test_fno_with_distributed_conv_module(world, inputs):
    """The FNO with the sharded conv on 4 model ranks against the JAX FNO
    with the same weights through its local fallback."""
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.distributed_fft import DistributedSpectralConv2d as J2

    assert inputs["fno2"]["fno_blocks"]["conv_0"]["w_weight"].shape == (2, 4, 4, 8, 5)
    jmesh._CURRENT_MESH = None
    want = np.asarray(JFNO(**FNO2_KW, conv_module=J2).apply({"params": inputs["fno2"]},
                                                             inputs["xy2"][0]))
    for got in world:
        np.testing.assert_allclose(got["fno"]["out2"], want, rtol=2e-4, atol=1e-5)


def test_distributed_conv_module_rejects_unsupported():
    from neuraloperator_tpu_torch.parallel.distributed_fft import (
        DistributedSpectralConv2d,
        DistributedSpectralConv3d,
    )

    for kwargs in ({"separable": True}, {"factorization": "cp"}, {"complex_data": True},
                   {"max_n_modes": (8, 8)}, {"resolution_scaling_factor": 2}):
        with pytest.raises(ValueError, match="does not support"):
            DistributedSpectralConv2d(2, 2, (4, 4), device="cpu", **kwargs)
    with pytest.raises(ValueError, match="2-D only"):
        DistributedSpectralConv2d(2, 2, (4, 4, 4), device="cpu")
    with pytest.raises(ValueError, match="3-D only"):
        DistributedSpectralConv3d(2, 2, (4, 4), device="cpu")
    conv = DistributedSpectralConv2d(2, 2, (4, 4), device="cpu")
    assert conv.w_weight.shape == (2, 2, 2, 4, 3) and conv.bias.shape == (2, 1, 1)
    with pytest.raises(ValueError, match="per-call"):
        conv(torch.zeros(1, 2, 8, 8), output_shape=(8, 8))


def test_fno_with_distributed_conv_trains_on_mesh(world, inputs):
    """The gradients through the all_to_all path against JAX's single-device ones."""
    import jax

    from neuraloperator_tpu.losses import LpLoss as JLp
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.distributed_fft import DistributedSpectralConv2d as J2

    jmesh._CURRENT_MESH = None
    model = JFNO(**FNO2_KW, conv_module=J2)
    x, y = inputs["xy2"]
    want = _leaves(jax.grad(lambda q: JLp(d=2)(model.apply({"params": q}, x), y))(
        inputs["fno2"]))
    for got in world:
        for name, g in want.items():
            np.testing.assert_allclose(got["fno"]["grads"][name], g, rtol=5e-4, atol=5e-5,
                                       err_msg=name)


@pytest.mark.parametrize("kd,kh,kw", CASES_3D)
def test_distributed_3d_matches_single_device(world, inputs, kd, kh, kw):
    from neuraloperator_tpu.layers.spectral_convolution import spectral_conv_forward
    from neuraloperator_tpu.tensor.factorized import FactorizationSpec

    x, w = inputs["conv3d"][(kd, kh, kw)]
    want = np.asarray(spectral_conv_forward(
        x, FactorizationSpec("dense", tuple(w.shape)), {"weight": w}, bias=None,
        n_modes=[kd, kh, kw], max_n_modes=[kd, kh, kw], complex_data=False, separable=False,
        implementation="reconstructed", fft_norm="forward", fno_block_precision="full",
        enforce_hermitian_symmetry=False, resolution_scaling_factor=None, output_shape=None,
        out_channels=w.shape[1]))
    for got in world:
        np.testing.assert_allclose(got["conv3d"][(kd, kh, kw)], want, rtol=3e-4, atol=3e-5)


def test_distributed_3d_gradients_flow(world, inputs):
    import jax
    import jax.numpy as jnp

    from neuraloperator_tpu.parallel.distributed_fft import distributed_spectral_conv3d

    x, w_st = inputs["grad3d"]
    mesh = _jax_mesh(4)

    def loss(w_st, x):
        w = jax.lax.complex(w_st[0], w_st[1])
        return jnp.sum(distributed_spectral_conv3d(x, w, (3, 4, 2), mesh, "model") ** 2)

    with mesh:
        want = np.asarray(jax.jit(jax.grad(loss))(w_st, x))
    for got in world:
        np.testing.assert_allclose(got["conv3d"]["grad"], want, rtol=2e-3, atol=2e-3)


def test_fno3d_with_distributed_conv_module(world, inputs):
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.parallel import mesh as jmesh
    from neuraloperator_tpu.parallel.distributed_fft import DistributedSpectralConv3d as J3

    jmesh._CURRENT_MESH = None
    want = np.asarray(JFNO(**FNO3_KW, conv_module=J3).apply({"params": inputs["fno3"]},
                                                             inputs["x3"]))
    for got in world:
        np.testing.assert_allclose(got["fno"]["out3"], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("stitching", [True, False], ids=["stitched", "unstitched"])
def test_patches_scattered_over_model_ranks_match_one_process(world, inputs, stitching):
    """MultigridPatching2D(use_distributed=True, mesh=) on a 2 x 2 mesh: one
    Trainer step and its evaluation against the same step in one process,
    which ``tests/test_torch_patching.py`` holds to JAX."""
    from neuraloperator_tpu_torch.data.transforms import MGPatchingDataProcessor
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.models import FNO
    from neuraloperator_tpu_torch.training import Trainer, adamw

    torch.manual_seed(0)
    model = FNO(n_modes=(4, 4), in_channels=2, out_channels=1, hidden_channels=8, n_layers=2,
                device="cpu")
    processor = MGPatchingDataProcessor(levels=1, padding_fraction=0.125, stitching=stitching)
    loader = [{"x": inputs["patch_x"], "y": inputs["patch_y"]}]
    want = Trainer(model=model, n_epochs=1, device="cpu", data_processor=processor).train(
        loader, {"test": loader}, adamw(1e-3), training_loss=LpLoss(d=2),
        eval_losses={"l2": LpLoss(d=2)})
    want_params = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for got in world:
        metrics, params, split = got["patching"][stitching]
        assert split
        for k in ("train_err", "test_l2"):
            np.testing.assert_allclose(metrics[k], want[k], rtol=1e-5, err_msg=k)
        for name, w in want_params.items():
            np.testing.assert_allclose(params[name], w, rtol=2e-4, atol=1e-6, err_msg=name)
