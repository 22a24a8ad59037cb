"""``TheWellDataProcessor`` and the_well's wrappers in the port, against the
JAX package.

The batches and normalizers are those of ``tests/test_the_well_processor.py``
(seeded numpy, the_well's layout: channels last); the port's normalizers are
fitted on the same arrays. Layout moves, flattening and concatenation are
held to the bit; normalized and unnormalized values within ``rtol=1e-6,
atol=1e-6`` (the same f32 arithmetic in another order). A Trainer that
trains two epochs on the_well's schema and then rolls out autoregressively
is held to the JAX Trainer from the same weights: the training loss within
``rtol=1e-5`` and the rollout's losses within ``rtol=1e-4`` (the bound of
``tests/test_torch_rollout.py``'s rollouts). The wrappers and
``train_mhd64 --data.well_base_path`` run on a stub ``the_well`` in
``sys.modules``, as ``tests/test_datasets.py`` stubs it.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import DataLoader as JLoader
from neuraloperator_tpu.data.datasets import DictDataset as JDict
from neuraloperator_tpu.data.transforms import TheWellDataProcessor as JWell
from neuraloperator_tpu.data.transforms.normalizers import UnitGaussianNormalizer as JNorm
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data.datasets import DataLoader, DictDataset
from neuraloperator_tpu_torch.data.transforms import TheWellDataProcessor, UnitGaussianNormalizer

torch.set_num_threads(1)

B, T_IN, C, CC, RES = 2, 2, 3, 2, 8
TOL = dict(rtol=1e-6, atol=1e-6)


def _well_batch(rng, n_out_steps=1, with_const=True, trajectory=False):
    """A batch in the_well's layout (the JAX test's)."""
    batch = {"output_fields": rng.randn(B, (T_IN + n_out_steps) if trajectory else n_out_steps,
                                        RES, RES, C).astype(np.float32)}
    if not trajectory:
        batch["input_fields"] = rng.randn(B, T_IN, RES, RES, C).astype(np.float32)
    if with_const:
        batch["constant_fields"] = rng.randn(B, RES, RES, CC).astype(np.float32)
    return batch


def _normalizers():
    """Channel-wise statistics on (b, c, t, spatial...) and on the constants,
    fitted on the same arrays by both packages."""
    rng = np.random.RandomState(7)
    data = rng.randn(4, C, 3, RES, RES).astype(np.float32) * 2 + 1
    const = rng.randn(4, CC, RES, RES).astype(np.float32) * 3 - 1
    return ((UnitGaussianNormalizer(dim=[0, 2, 3, 4]).fit(data),
             UnitGaussianNormalizer(dim=[0, 2, 3]).fit(const)),
            (JNorm(dim=[0, 2, 3, 4]).fit(data), JNorm(dim=[0, 2, 3]).fit(const)))


def _pair(**kw):
    """The port's processor and JAX's with the same settings and normalizers."""
    normalized = kw.pop("normalized", False)
    (dn, cn), (jdn, jcn) = _normalizers() if normalized else ((None, None), (None, None))
    return (TheWellDataProcessor(data_normalizer=dn, const_normalizer=cn, **kw),
            JWell(data_normalizer=jdn, const_normalizer=jcn, **kw))


def _same(got, want, exact=False):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("with_const", [False, True])
def test_preprocess_and_eval_postprocess_match_jax(normalized, with_const):
    """Permutes, t-major time flattening, the normalizers and the constants on
    a window batch; the evaluation's unnormalized prediction and target."""
    rng = np.random.RandomState(1)
    batch = _well_batch(rng, with_const=with_const)
    ours, ref = _pair(n_steps_input=T_IN, normalized=normalized)
    out, jout = ours.preprocess(dict(batch), train=True), ref.preprocess(dict(batch), train=True)
    assert set(out) == set(jout) == {"x", "y"}
    assert out["x"].shape == (B, T_IN * C + (CC if with_const else 0), RES, RES)
    for k in ("x", "y"):
        _same(out[k], jout[k], exact=not normalized)
    pred = rng.randn(B, C, RES, RES).astype(np.float32)
    up, sample = ours.postprocess(torch.from_numpy(pred), dict(out), train=False)
    jup, jsample = ref.postprocess(jnp.asarray(pred), dict(jout), train=False)
    _same(up, jup, exact=not normalized)
    _same(sample["y"], jsample["y"], exact=not normalized)


def test_spatiotemporal_layout_matches_jax():
    """``time_as_channels=False``: x keeps its time axis, the constants are
    repeated along it; two output steps."""
    rng = np.random.RandomState(2)
    batch = _well_batch(rng, n_out_steps=2)
    ours, ref = _pair(n_steps_input=T_IN, n_steps_output=2, time_as_channels=False,
                      normalized=True)
    out, jout = ours.preprocess(dict(batch)), ref.preprocess(dict(batch))
    assert out["x"].shape == (B, C + CC, T_IN, RES, RES)
    for k in ("x", "y"):
        _same(out[k], jout[k])
    with pytest.raises(ValueError, match="n_steps_output == 1"):
        TheWellDataProcessor(n_steps_output=2, time_as_channels=True)


@pytest.mark.parametrize("time_as_channels", [True, False])
def test_rollout_batch_and_feedback_match_jax(time_as_channels):
    """``format_rollout_batch`` of a trajectory (the first input steps as x,
    the raw rest as (b, T, c, spatial...) targets) and two steps of
    ``ar_feedback`` (the window moved, the normalized prediction appended,
    the constants kept), with and without time as channels."""
    rng = np.random.RandomState(3)
    batch = _well_batch(rng, trajectory=True, n_out_steps=3)
    ours, ref = _pair(n_steps_input=T_IN, time_as_channels=time_as_channels, normalized=True)
    fmt, jfmt = ours.format_rollout_batch(dict(batch)), ref.format_rollout_batch(dict(batch))
    _same(fmt["x"], jfmt["x"])
    _same(fmt["y"], jfmt["y"], exact=True)
    x, jx = fmt["x"], jfmt["x"]
    for _ in range(2):
        shape = (B, C, RES, RES)
        pred = rng.randn(*shape).astype(np.float32)
        x, jx = ours.ar_feedback(x, torch.from_numpy(pred)), ref.ar_feedback(jx, jnp.asarray(pred))
        _same(x, jx)
    # the constants ride along unchanged
    n_var = T_IN * C if time_as_channels else C
    _same(x[:, n_var:], fmt["x"][:, n_var:].numpy(), exact=True)


def test_formatted_samples_keep_the_older_path():
    """``{'x', 'y'}`` samples: normalized x (and y when training), the last
    prediction fed back at ``step > 0``, as in JAX."""
    (dn, _), (jdn, _) = _normalizers()
    x = np.random.RandomState(5).randn(2, C, 1, RES, RES).astype(np.float32)
    ours, ref = TheWellDataProcessor(normalizer=dn), JWell(normalizer=jdn)
    s, js = ours.preprocess({"x": torch.from_numpy(x), "y": torch.from_numpy(2 * x)}), \
        ref.preprocess({"x": jnp.asarray(x), "y": jnp.asarray(2 * x)})
    for k in ("x", "y"):
        _same(s[k], js[k])
    out, _ = ours.postprocess(s["x"] * 2, s, train=False)
    jout, _ = ref.postprocess(js["x"] * 2, js, train=False)
    _same(out, jout)
    s1 = TheWellDataProcessor().preprocess({"x": torch.from_numpy(x), "y": None}, step=0)
    plain = TheWellDataProcessor()
    plain.postprocess(s1["x"] * 2, s1, train=False)
    _same(plain.preprocess({"x": torch.from_numpy(x), "y": None}, step=1)["x"], 2 * x, exact=True)


def _items(rng, n):
    window = [{"input_fields": rng.randn(T_IN, RES, RES, C).astype(np.float32),
               "output_fields": rng.randn(1, RES, RES, C).astype(np.float32),
               "constant_fields": rng.randn(RES, RES, CC).astype(np.float32)}
              for _ in range(n)]
    trajectories = [{"output_fields": rng.randn(T_IN + 3, RES, RES, C).astype(np.float32),
                     "constant_fields": rng.randn(RES, RES, CC).astype(np.float32)}
                    for _ in range(n)]
    return window, trajectories


def test_trainer_trains_on_the_well_and_rolls_out_as_jax():
    """Two epochs on the_well's window batches, then an autoregressive
    evaluation of trajectories capped at the processor's n_steps_rollout, by
    the port's Trainer and JAX's from the same weights."""
    from neuraloperator_tpu.losses import LpLoss as JLp
    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.training import Trainer as JTrainer
    from neuraloperator_tpu.training import adamw as jadamw
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.models import FNO
    from neuraloperator_tpu_torch.training import Trainer, adamw

    window, trajectories = _items(np.random.RandomState(4), 8)
    kw = dict(n_modes=(4, 4), in_channels=T_IN * C + CC, out_channels=C, hidden_channels=8,
              n_layers=1)
    jmodel = JFNO(**kw)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, T_IN * C + CC, RES, RES)))["params"]
    model = FNO(**kw, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    ours, ref = _pair(n_steps_input=T_IN, n_steps_rollout=2, normalized=True)

    trainer = Trainer(model=model, n_epochs=2, device="cpu", data_processor=ours, eval_interval=10)
    metrics = trainer.train(DataLoader(DictDataset(window), 4), {}, adamw(1e-3),
                            training_loss=LpLoss(d=2))
    jtrainer = JTrainer(model=jmodel, n_epochs=2, data_processor=ref, eval_interval=10)
    jtrainer.params = params
    jmetrics = jtrainer.train(JLoader(JDict(window), 4), {}, jadamw(1e-3),
                              training_loss=JLp(d=2))
    np.testing.assert_allclose(metrics["train_err"], jmetrics["train_err"], rtol=1e-5)

    losses = {"l2": LpLoss(d=2), "h1": LpLoss(d=2, p=1)}
    vals = trainer.evaluate(None, DataLoader(DictDataset(trajectories), 4), "well",
                            mode="autoregression", eval_losses=losses)
    jvals = jtrainer.evaluate(None, JLoader(JDict(trajectories), 4), "well",
                              mode="autoregression",
                              eval_losses={"l2": JLp(d=2), "h1": JLp(d=2, p=1)})
    assert trainer._last_rollout_T == jtrainer._last_rollout_T == 2
    assert set(vals) == set(jvals) == {"well_l2", "well_h1"}
    for k, v in jvals.items():
        assert np.isfinite(vals[k])
        np.testing.assert_allclose(vals[k], v, rtol=1e-4, err_msg=k)


class _FakeWellDataset:
    """the_well's ``WellDataset`` as ``tests/test_datasets.py`` stubs it."""

    def __init__(self, well_base_path, well_dataset_name, well_split_name, n_steps_input,
                 n_steps_output, **kwargs):
        self.name, self.split = well_dataset_name, well_split_name
        self.n_in, self.n_out = n_steps_input, n_steps_output
        self.res = kwargs.get("res", 4)

    def __len__(self):
        return 3

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx + (0 if self.split == "train" else 10))
        shape = (self.res,) * 3
        return {"input_fields": rng.randn(self.n_in, *shape, 2).astype(np.float32),
                "output_fields": rng.randn(self.n_out, *shape, 2).astype(np.float32),
                "name": self.name}


@pytest.fixture
def stub_the_well(monkeypatch):
    pkg, data = types.ModuleType("the_well"), types.ModuleType("the_well.data")
    data.WellDataset = _FakeWellDataset
    pkg.data = data
    monkeypatch.setitem(sys.modules, "the_well", pkg)
    monkeypatch.setitem(sys.modules, "the_well.data", data)


def test_the_well_wrappers_match_jax_with_a_stub_package(stub_the_well):
    from neuraloperator_tpu.data.datasets import the_well_dataset as jtw
    from neuraloperator_tpu_torch.data.datasets import (
        ActiveMatterDataset,
        MHD64Dataset,
        WellDataset,
    )

    pairs = [(WellDataset("/tmp/well", "active_matter", "train", n_steps_input=2,
                          n_steps_output=1),
              jtw.WellDataset("/tmp/well", "active_matter", "train", n_steps_input=2,
                              n_steps_output=1)),
             (ActiveMatterDataset("/tmp/well"), jtw.ActiveMatterDataset("/tmp/well")),
             (MHD64Dataset("/tmp/well", well_split_name="valid"),
              jtw.MHD64Dataset("/tmp/well", well_split_name="valid"))]
    for ours, ref in pairs:
        assert len(ours) == len(ref) == 3
        assert ours._ds.split == ref._ds.split
        for i in range(3):
            got, want = ours[i], ref[i]
            assert set(got) == set(want) and got["name"] == want["name"]
            for k in ("input_fields", "output_fields"):
                assert isinstance(got[k], np.ndarray)
                np.testing.assert_array_equal(got[k], want[k])


def test_the_well_wrappers_raise_without_the_package(monkeypatch):
    from neuraloperator_tpu.data.datasets import the_well_dataset as jtw
    from neuraloperator_tpu_torch.data.datasets import WellDataset

    monkeypatch.setitem(sys.modules, "the_well", None)
    with pytest.raises(ImportError, match="the_well") as ours:
        WellDataset("/tmp/well", "active_matter", "train")
    with pytest.raises(ImportError) as ref:
        jtw.WellDataset("/tmp/well", "active_matter", "train")
    assert str(ours.value) == str(ref.value)


def test_mhd_script_trains_on_the_well(stub_the_well, capsys):
    """``train_mhd64 --data.well_base_path`` reads MHD64Dataset's "train" and
    "valid" splits through TheWellDataProcessor, its model's channels from
    the first item (one input step of 2 channels), and trains."""
    from neuraloperator_tpu_torch.scripts import train_mhd64 as tmhd

    metrics = tmhd.main(["--data.well_base_path", "/data/the_well", "--opt.n_epochs", "1",
                         "--model.n_modes", "[2,2,2]", "--model.hidden_channels", "4",
                         "--device", "cpu"])
    assert np.isfinite(metrics["train_err"]) and np.isfinite(metrics["mhd_l2"])
    assert "final:" in capsys.readouterr().out
