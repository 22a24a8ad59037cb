"""The port's multigrid patching (MG-TFNO) against the JAX package.

Same numpy inputs through both packages, on the CPU:

* ``make_patches``, ``MultigridPatching2D`` (levels 1 and 2, padding 0 and
  0.1, ``stitching`` True and False: patch, then unpatch in training and in
  evaluation), the patching transforms and ``MGPatchingDataProcessor``:
  to the bit (pads, slices and stacks move values without arithmetic; the
  normalizers' f32 arithmetic is the same elementwise expression);
* one patched FNO step through the ``Trainer``, on the loader loop and on the
  staged path: the loss within ``rtol=1e-5`` and each gradient within 1e-4,
  leaf by leaf, each leaf's l2 error against the larger of its norm and 1%
  of the whole gradient's (``tests/test_torch_gino.py``): the projection's
  last bias takes the mean of the H1 residual, which nearly cancels (1e-5
  against gradients of order 1), so its own norm is no scale for rounding;
* the patched ``train_navier_stokes`` (32², 16 pairs, 2 epochs, warm-started
  from one JAX init): the final metrics within ``rtol=1e-5``, the bound of
  ``tests/test_torch_train_script.py``.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuraloperator_tpu.data.datasets import navier_stokes as jns
from neuraloperator_tpu.data.datasets import tensor_dataset as jds
from neuraloperator_tpu.data.transforms import base_transforms as jbase
from neuraloperator_tpu.data.transforms import data_processors as jdp
from neuraloperator_tpu.data.transforms import normalizers as jnorm
from neuraloperator_tpu.data.transforms import patching_transforms as jpt
from neuraloperator_tpu.losses import data_losses as jl
from neuraloperator_tpu.models import get_model as jget_model
from neuraloperator_tpu.training import patching as jpatch
from neuraloperator_tpu.training import trainer as jtrainer
from neuraloperator_tpu.training import training_state as jts
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
from neuraloperator_tpu_torch.data.datasets import navier_stokes as tns
from neuraloperator_tpu_torch.data.transforms import (
    CompositeTransform,
    DictTransform,
    MGPatchingDataProcessor,
    MGPatchingTransform,
    MGPTensorDataset,
    RandomMGPatch,
    UnitGaussianNormalizer,
)
from neuraloperator_tpu_torch.losses import H1Loss, LpLoss
from neuraloperator_tpu_torch.models import get_model
from neuraloperator_tpu_torch.scripts import train_navier_stokes as tscript
from neuraloperator_tpu_torch.training import Trainer, adamw
from neuraloperator_tpu_torch.training.patching import MultigridPatching2D, make_patches

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _field(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bits(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,p,shape", [
    (2, 0, (2, 3, 16, 16)), (2, 1, (2, 1, 8, 8)), ([2, 4], [3, 1], (1, 2, 12, 16)),
    (1, 2, (2, 1, 8, 8)), (1, 0, (1, 1, 8, 8)), (4, 2, (2, 2, 16)), (1, 3, (1, 1, 8)),
])
def test_make_patches_matches_jax(n, p, shape):
    x = _field(0, shape)
    _bits(make_patches(torch.from_numpy(x), n, p), jpatch.make_patches(jnp.asarray(x), n, p))


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("padding", [0, 0.1])
@pytest.mark.parametrize("stitching", [True, False])
def test_multigrid_patching_matches_jax(levels, padding, stitching):
    x, y = _field(1, (2, 2, 32, 32)), _field(2, (2, 1, 32, 32))
    ours = MultigridPatching2D(levels=levels, padding_fraction=padding, stitching=stitching)
    ref = jpatch.MultigridPatching2D(levels=levels, padding_fraction=padding,
                                     stitching=stitching)
    px, py = ours.patch(torch.from_numpy(x), torch.from_numpy(y))
    jx, jy = ref.patch(jnp.asarray(x), jnp.asarray(y))
    _bits(px, jx)
    _bits(py, jy)
    assert (ours.padding_height, ours.padding_width) == (ref.padding_height, ref.padding_width)
    # a model output of one channel per patch, unpatched in training and in evaluation
    out = np.asarray(jx)[:, :1] * 2
    for evaluation in (False, True):
        ux, uy = ours.unpatch(torch.from_numpy(out), py, evaluation=evaluation)
        jux, juy = ref.unpatch(jnp.asarray(out), jy, evaluation=evaluation)
        _bits(ux, jux)
        _bits(uy, juy)
    if stitching or padding == 0:
        # the fine channel of the patches stitches back to the input
        back, _ = ours.unpatch(px[:, :2], py, evaluation=True)
        _bits(back, x)


def test_patcher_reads_the_padding_of_its_last_input():
    ours = MultigridPatching2D(levels=1, padding_fraction=0.1)
    ours.patch(torch.zeros(1, 1, 32, 32), torch.zeros(1, 1, 32, 32))
    assert (ours.padding_height, ours.padding_width) == (3, 3)
    px, _ = ours.patch(torch.zeros(1, 1, 16, 16), torch.zeros(1, 1, 16, 16))
    assert (ours.padding_height, ours.padding_width) == (2, 2)
    assert ours.unpatch(px[:, :1], None, evaluation=True)[0].shape == (1, 1, 16, 16)


def test_distribution_is_refused():
    """Distribution is ported (tests/test_torch_distributed_fft.py scatters the
    patches over two model ranks): without a mesh, or at model size 1, the
    patches stay whole on the rank, as JAX's stay on one device."""
    from types import SimpleNamespace

    x, y = _field(1, (2, 1, 16, 16)), _field(2, (2, 1, 16, 16))
    plain = MultigridPatching2D(levels=1, padding_fraction=0.125)
    want = plain.patch(torch.from_numpy(x), torch.from_numpy(y))[0]
    one_rank = SimpleNamespace(shape={"data": 1, "model": 1})
    for kwargs in ({"use_distributed": True}, {"use_distributed": True, "mesh": one_rank}):
        patcher = MultigridPatching2D(levels=1, padding_fraction=0.125, **kwargs)
        assert not patcher.splits_over_model
        _bits(patcher.patch(torch.from_numpy(x), torch.from_numpy(y))[0], want)


def test_patching_transforms_match_jax():
    x, y = _field(3, (5, 1, 16, 16)), _field(4, (5, 1, 16, 16))
    t = MGPatchingTransform(levels=2, padding_fraction=0.125)
    jt = jpt.MGPatchingTransform(levels=2, padding_fraction=0.125)
    px = t.transform(torch.from_numpy(x))
    _bits(px, jt.transform(jnp.asarray(x)))
    _bits(t.inverse_transform(px[:, :1]), jt.inverse_transform(jnp.asarray(px[:, :1].numpy())))
    ours, ref = RandomMGPatch(levels=1, seed=7), jpt.RandomMGPatch(levels=1, seed=7)
    for i in range(5):
        for a, b in zip(ours.transform((x[i], y[i])), ref.transform((x[i], y[i]))):
            _bits(a, b)
    ds, jds_ = MGPTensorDataset(x, y, levels=1, seed=3), jpt.MGPTensorDataset(x, y, levels=1,
                                                                              seed=3)
    assert len(ds) == len(jds_) == 5
    for i in (0, 4, 2):
        for k in ("x", "y"):
            _bits(ds[i][k], jds_[i][k])
    with pytest.raises(NotImplementedError):
        ours.inverse_transform((x[0], y[0]))


def test_composite_and_dict_transforms_match_jax():
    x = _field(5, (4, 2, 8, 8))
    norm = UnitGaussianNormalizer(dim=[0, 2, 3]).fit(x)
    jn = jnorm.UnitGaussianNormalizer(dim=[0, 2, 3]).fit(x)
    comp = CompositeTransform([norm, MGPatchingTransform(levels=1)])
    jcomp = jbase.CompositeTransform([jn, jpt.MGPatchingTransform(levels=1)])
    got = comp.transform(torch.from_numpy(x))
    _bits(got, jcomp.transform(jnp.asarray(x)))
    _bits(comp(torch.from_numpy(x)), got)
    # inverse: stitch, then de-normalize, in reverse order
    _bits(comp.inverse_transform(got[:, :2]),
          jcomp.inverse_transform(jnp.asarray(got[:, :2].numpy())))
    d = DictTransform({"x": norm})
    jd = jbase.DictTransform({"x": jn})
    sample = {"x": torch.from_numpy(x), "y": torch.ones(2)}
    out, jout = d.transform(sample), jd.transform({"x": jnp.asarray(x), "y": jnp.ones(2)})
    _bits(out["x"], jout["x"])
    assert out["y"] is sample["y"]
    _bits(d.inverse_transform(out)["x"], jd.inverse_transform(jout)["x"])


@pytest.mark.parametrize("stitching", [True, False])
def test_mg_patching_data_processor_matches_jax(stitching):
    x, y = _field(6, (2, 1, 32, 32)), _field(7, (2, 1, 32, 32))
    norms = [UnitGaussianNormalizer(dim=[0, 2, 3]).fit(a) for a in (x, y)]
    jnorms = [jnorm.UnitGaussianNormalizer(dim=[0, 2, 3]).fit(a) for a in (x, y)]
    dp = MGPatchingDataProcessor(levels=1, padding_fraction=0.078125, stitching=stitching,
                                 in_normalizer=norms[0], out_normalizer=norms[1])
    jdp_ = jdp.MGPatchingDataProcessor(levels=1, padding_fraction=0.078125,
                                       stitching=stitching, in_normalizer=jnorms[0],
                                       out_normalizer=jnorms[1])
    for train in (True, False):
        s = dp.preprocess({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, train=train)
        js = jdp_.preprocess({"x": jnp.asarray(x), "y": jnp.asarray(y)}, train=train)
        for k in ("x", "y"):
            _bits(s[k], js[k])
        assert s["x"].shape[0] == 8
        out = s["x"][:, :1] * 0.5 + 0.25
        o, s2 = dp.postprocess(out, s, train=train)
        jo, js2 = jdp_.postprocess(jnp.asarray(out.numpy()), js, train=train)
        _bits(o, jo)
        _bits(s2["y"], js2["y"])
        assert o.shape == ((2, 1, 32, 32) if stitching or not train else (8, 1, 16, 16))


# ---------------------------------------------------------------------------
# the patched FNO through the Trainer

def _config(levels=1):
    return {"model": {"model_arch": "fno", "data_channels": 1, "out_channels": 1,
                      "n_modes": [4, 4], "hidden_channels": 8, "n_layers": 2,
                      "projection_channel_ratio": 2},
            "patching": {"levels": levels}}


def _both_models(seed=0):
    jmodel = jget_model(_config())
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2, 10, 10)))["params"]
    model = get_model(_config(), device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return jmodel, params, model


def _capture_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g),
    )


def _grad_errors(got: dict, want: dict) -> dict:
    """Per-leaf l2 error against the larger of the leaf's norm and 1% of the
    whole gradient's."""
    want = {n: np.asarray(w, np.float64) for n, w in want.items()}
    total = sum(float(np.square(w).sum()) for w in want.values()) ** 0.5
    return {n: float(np.linalg.norm(np.asarray(got[n], np.float64) - w)
                     / max(np.linalg.norm(w), 1e-2 * total)) for n, w in want.items()}


@pytest.mark.parametrize("device_dataset", [False, True])
def test_one_patched_trainer_step_matches_jax(device_dataset):
    """levels 1 with padding on 16² fields: 4 patches of 10² with 2 channels.
    The first step's loss and gradients against the JAX Trainer's."""
    jmodel, params, model = _both_models()
    x = _field(8, (4, 1, 16, 16))
    y = (0.5 * np.roll(x, 1, axis=-1) + 0.25 * x ** 2).astype(np.float32)
    norms = [UnitGaussianNormalizer(dim=[0, 2, 3]).fit(a) for a in (x, y)]
    jnorms = [jnorm.UnitGaussianNormalizer(dim=[0, 2, 3]).fit(a) for a in (x, y)]
    dp = MGPatchingDataProcessor(levels=1, padding_fraction=0.125, in_normalizer=norms[0],
                                 out_normalizer=norms[1])
    jdp_ = jdp.MGPatchingDataProcessor(levels=1, padding_fraction=0.125,
                                       in_normalizer=jnorms[0], out_normalizer=jnorms[1])
    grab = jtrainer.Trainer(model=jmodel, n_epochs=1, data_processor=jdp_)
    grab.params = params
    want = grab.train(jds.DataLoader(jds.TensorDataset(x, y), 4), {}, _capture_grads(),
                      training_loss=jl.H1Loss(d=2), device_dataset=device_dataset)
    j_grads = convert.flatten_flax(grab.opt_state)

    trainer = Trainer(model=model, n_epochs=1, data_processor=dp, device="cpu")
    got = trainer.train(DataLoader(TensorDataset(x, y), 4), {}, adamw(0.0),
                        training_loss=H1Loss(d=2), device_dataset=device_dataset)
    np.testing.assert_allclose(got["train_err"], want["train_err"], rtol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(j_grads)
    errors = _grad_errors({n: p.grad.numpy() for n, p in named.items()}, j_grads)
    assert max(errors.values()) <= 1e-4, errors
    if device_dataset:
        # the patched path computes the H1 denominators in the step, not staged
        assert "_loss_ynorm_sq" not in trainer.staged_step.data


def test_the_patched_model_takes_the_coarse_channels():
    _, _, model = _both_models()
    assert model.lifting.w0.shape[1] == 2 + 2  # (levels + 1) data + 2 grid


# ---------------------------------------------------------------------------
# the patched entry point against the JAX script

ARGS = [
    "--data.n_train", "16", "--data.train_resolution", "32", "--data.n_tests", "[8]",
    "--data.test_resolutions", "[32]", "--data.test_batch_sizes", "[4]",
    "--data.batch_size", "4", "--model.n_modes", "[8,8]", "--model.hidden_channels", "8",
    "--model.n_layers", "2", "--opt.learning_rate", "1e-3", "--opt.step_size", "1",
    "--opt.opt_state", "factored", "--opt.training_loss", "h1", "--opt.mixed_precision",
    "false", "--eval_interval", "1", "--patching.levels", "1", "--opt.n_epochs", "2",
]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_navier_stokes",
                                                  ROOT / "scripts/train_navier_stokes.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("extra", [["--device_dataset", "true"],
                                   ["--patching.stitching", "false"]],
                         ids=["staged", "unstitched"])
def test_the_patched_entry_point_matches_jax(tmp_path, monkeypatch, capsys, extra):
    data = tmp_path / "data"
    jns.generate_navier_stokes_files(data, n_train=16, n_test=8, res=32, T=0.05, seed=3)
    monkeypatch.setattr(tns, "DATA_ROOT", data)
    from neuraloperator_tpu.config import make_config_from_cli

    module = _jax_script()
    argv = [*ARGS, *extra]
    config = make_config_from_cli(module.NSConfig, list(argv))
    params = jget_model(config.to_dict()).init(
        jax.random.PRNGKey(4), np.zeros((1, 2, 20, 20), np.float32))["params"]
    jts.save_training_state(tmp_path / "init", "best_model", params)
    argv += ["--warm_start_from", str(tmp_path / "init")]

    precision = jax.config.jax_default_matmul_precision
    monkeypatch.setattr(module, "load_navier_stokes_pt",
                        functools.partial(jns.load_navier_stokes_pt, data_root=data))
    monkeypatch.setattr(sys, "argv", ["train_navier_stokes.py", *argv])
    try:
        want = module.main()
    finally:
        jax.config.update("jax_default_matmul_precision", precision)
    capsys.readouterr()
    got = tscript.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final: {'train_err'" in out
    assert set(got) == set(want) == {"train_err", "epoch_time", "32_h1", "32_l2"}
    for k in ("train_err", "32_h1", "32_l2"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
