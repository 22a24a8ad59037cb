"""OTNO's data and model in the PyTorch port against the JAX package, on
the CPU.

- ``sinkhorn_log`` on numpy arrays is JAX's function (the same numpy: equal
  to the bit); on float64 tensors it runs the same iteration with
  ``torch.logsumexp``, and its plan lies within 1e-10 of JAX's, relative to
  the plan's largest entry (the iteration is contractive: the last-bit
  differences of the two reductions do not grow);
- ``OTDataModule`` on synthetic bodies normalized as the script normalizes
  them (160-256 vertices, latent 8² and 12², the script's ``reg`` and 200
  iterations, and a ``reg`` at which the ``tol`` stop ends the solve early):
  the plan within 1e-10, and the index maps equal to JAX's argmaxes except
  where the two plans' choices lie within 1e-9 of each other, relative to
  the row's (or column's) largest entry: a near tie, counted and printed;
  the transported features equal to the bit where the maps agree;
- the OTNO forward and its parameter gradients (of a fixed weighted sum of
  the outputs) from JAX's converted weights, within 1e-5 and 1e-4 (each
  leaf against the larger of its norm and 1% of the whole gradient's), at
  hidden 8, 2 layers, (4, 4) modes on an 8² latent grid; JAX contracts with
  its plain XLA path on the CPU;
- ``CFDDataProcessor`` (tensors where JAX's gives numpy arrays, within 1e-6)
  and the OT archives against JAX's, and
  ``load_car_ot`` raising ``FileNotFoundError`` without an archive.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import car_ot_dataset as jcar
from neuraloperator_tpu.data.datasets import ot_datamodule as jot
from neuraloperator_tpu.data.datasets import synthetic_cfd as jcfd
from neuraloperator_tpu.data.transforms.normalizers import UnitGaussianNormalizer as JNorm
from neuraloperator_tpu.models import OTNO as JOTNO
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data import datasets as tdatasets
from neuraloperator_tpu_torch.data.datasets import car_ot_dataset as tcar
from neuraloperator_tpu_torch.data.datasets import ot_datamodule as tot
from neuraloperator_tpu_torch.data.transforms import UnitGaussianNormalizer
from neuraloperator_tpu_torch.models import OTNO, get_model

torch.set_num_threads(1)

PLAN_TOL, TIE_MARGIN = 1e-10, 1e-9
TOL, GRAD_TOL = 1e-5, 1e-4


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def body(n_verts: int, seed: int) -> np.ndarray:
    """A synthetic body's vertices, centred and scaled as the script does."""
    verts = jcfd.generate_cfd_sample(np.random.default_rng(seed), n_verts=n_verts,
                                     grid_n=4)["vertices"].astype(np.float32)
    center = verts.mean(0)
    return (verts - center) / np.abs(verts - center).max()


def near_ties(plan: np.ndarray, got: np.ndarray, want: np.ndarray, axis: int) -> int:
    """How many maps differ; each difference must pick an entry within
    ``TIE_MARGIN`` of JAX's choice, relative to the largest entry."""
    diff = np.nonzero(got != want)[0]
    for i in diff:
        line = plan[i] if axis == 1 else plan[:, i]
        gap = abs(line[want[i]] - line[got[i]]) / line.max()
        assert gap <= TIE_MARGIN, (axis, i, gap)
    return len(diff)


def test_sinkhorn_numpy_is_jax_and_torch_within_1e10():
    rng = np.random.default_rng(0)
    src, dst = rng.random((40, 3)), rng.random((70, 3))
    C = ((src[:, None] - dst[None]) ** 2).sum(-1)
    a, b = np.full(40, 1 / 40), np.full(70, 1 / 70)
    for reg, n_iters in ((5e-3, 200), (5e-2, 500)):
        want = jot.sinkhorn_log(a, b, C, reg=reg, n_iters=n_iters)
        np.testing.assert_array_equal(tot.sinkhorn_log(a, b, C, reg=reg, n_iters=n_iters), want)
        got = tot.sinkhorn_log(*map(torch.from_numpy, (a, b, C)), reg=reg, n_iters=n_iters)
        assert got.dtype == torch.float64
        assert np.abs(got.numpy() - want).max() / want.max() < PLAN_TOL
    assert tdatasets.sinkhorn_log is tot.sinkhorn_log


@pytest.mark.parametrize("n_verts,latent,reg,seed", [(256, 8, 5e-3, 0), (160, 12, 5e-3, 1),
                                                      (256, 8, 5e-2, 2)])
def test_ot_maps_match_jax(n_verts, latent, reg, seed):
    verts = body(n_verts, seed)
    want = jot.OTDataModule(verts, latent_size=latent, reg=reg, n_iters=200)
    got = tot.OTDataModule(verts, latent_size=latent, reg=reg, n_iters=200, device="cpu")
    np.testing.assert_array_equal(got.source, want.source)
    plan = got.plan.numpy()
    assert plan.dtype == np.float64
    assert np.abs(plan - want.plan).max() / want.plan.max() < PLAN_TOL
    enc = near_ties(want.plan, got.ind_enc.numpy(), want.ind_enc, axis=1)
    dec = near_ties(want.plan, got.ind_dec.numpy(), want.ind_dec, axis=0)
    print(f"near ties: {enc} of {latent ** 2} encoder, {dec} of {n_verts} decoder indices")
    feats = got.transported_features(verts).numpy()
    expected = want.transported_features(verts)
    assert feats.dtype == np.float32 and feats.shape == expected.shape == (1, 6, latent, latent)
    if enc == 0:
        np.testing.assert_array_equal(feats, expected)
    extras = np.random.default_rng(3).standard_normal((n_verts, 2)).astype(np.float32)
    assert got.transported_features(verts, extras).shape == (1, 8, latent, latent)
    if enc == 0:
        np.testing.assert_array_equal(got.transported_features(verts, extras).numpy(),
                                      want.transported_features(verts, extras))


def test_ot_module_refuses_the_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tot.OTDataModule(body(64, 0), latent_size=4)


@pytest.fixture(scope="module")
def otno_case():
    """JAX's tiny OTNO, its weights in the port's, and one mesh's inputs."""
    kw = dict(n_modes=(4, 4), in_channels=6, out_channels=1, hidden_channels=8, n_layers=2)
    verts = body(96, 4)
    dm = jot.OTDataModule(verts, latent_size=8, reg=5e-3, n_iters=200)
    x, ind = dm.transported_features(verts), dm.ind_dec
    jm = JOTNO(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ind))["params"]
    model = OTNO(**kw, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return dict(jm=jm, params=params, model=model, x=x, ind=ind)


def test_otno_forward_and_gradients_match_jax(otno_case):
    c = otno_case
    wsum = np.random.default_rng(5).standard_normal((1, len(c["ind"]))).astype(np.float32)

    def jloss(p):
        out = c["jm"].apply({"params": p}, jnp.asarray(c["x"]), jnp.asarray(c["ind"]))
        return jnp.sum(out * wsum), out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(c["params"])
    model = c["model"]
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(c["x"]), torch.from_numpy(c["ind"]))
    assert out.shape == (1, 96)
    assert rel(out.detach().numpy(), want) < TOL
    (out * torch.from_numpy(wsum)).sum().backward()
    flat = {k: np.asarray(v) for k, v in convert.flatten_flax(jgrads).items()}
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(flat)
    total = sum(float(np.square(w.astype(np.float64)).sum()) for w in flat.values()) ** 0.5
    for n, w in flat.items():
        err = np.linalg.norm(got[n] - w) / max(np.linalg.norm(w), 1e-2 * total)
        assert err < GRAD_TOL, (n, err)


def test_otno_defaults_and_registry_match_jax():
    params = inspect.signature(OTNO).parameters
    for name in ("in_channels", "out_channels", "hidden_channels", "positional_embedding",
                 "use_channel_mlp", "channel_mlp_expansion", "norm"):
        assert params[name].default == getattr(JOTNO, name), name
    model = get_model({"model_arch": "otno", "n_modes": [4, 4], "hidden_channels": 8,
                       "n_layers": 1}, device="cpu")
    assert type(model) is OTNO and model._init_kwargs["norm"] == "group_norm"


def _ot_sample(rng, s: int, n: int) -> dict:
    return {"source": rng.standard_normal((s * s, 3)).astype(np.float32),
            "trans": rng.standard_normal((s * s, 3)).astype(np.float32),
            "ind_dec": rng.integers(0, s * s, n), "press": rng.standard_normal(n + 3)}


def test_cfd_data_processor_matches_jax():
    sample = _ot_sample(np.random.default_rng(6), 4, 20)
    y = np.random.default_rng(7).standard_normal((5, 1, 20)).astype(np.float32)
    for train in (True, False):
        for norms in ((None, None), (UnitGaussianNormalizer(dim=[0, 2]).fit(y),
                                     JNorm(dim=[0, 2]).fit(y))):
            got = tcar.CFDDataProcessor(norms[0]).preprocess(sample, train=train)
            want = jcar.CFDDataProcessor(norms[1]).preprocess(sample, train=train)
            assert set(got) == set(want)
            for key in ("x", "ind_dec", "y"):
                assert isinstance(got[key], torch.Tensor)
                assert got[key].numpy().dtype == np.asarray(want[key]).dtype, key
                np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                           rtol=1e-6, err_msg=key)
            assert got["x"].shape == (1, 6, 4, 4)
            out = np.ones((1, 20), np.float32)
            p_out, _ = tcar.CFDDataProcessor(norms[0]).postprocess(torch.from_numpy(out), got,
                                                                   train=train)
            j_out, _ = jcar.CFDDataProcessor(norms[1]).postprocess(out, want, train=train)
            np.testing.assert_allclose(np.asarray(p_out), np.asarray(j_out), rtol=1e-6)


def test_ot_archives_load_as_in_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match="ot_"):
        tcar.load_car_ot(tmp_path)
    with pytest.raises(FileNotFoundError, match="ot_"):
        tcar.CarOTDataset()
    rng = np.random.default_rng(8)
    samples = [_ot_sample(rng, 3, 10) for _ in range(3)]
    torch.save([{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()} for s in samples],
               tmp_path / "ot_mini.pt")
    got, want = tcar.load_car_ot(tmp_path), jcar.load_car_ot(tmp_path)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])
    ds = tcar.load_saved_ot(n_train=2, n_test=1, data_root=tmp_path)
    assert len(ds.train_data) == 2 and len(ds.test_data) == 1
    np.testing.assert_array_equal(ds.test_data[0]["trans"], samples[2]["trans"])
    assert tdatasets.CFDDataProcessor is tcar.CFDDataProcessor
