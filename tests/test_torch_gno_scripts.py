"""The GNO family's data, the Poisson losses and the three entry points of
the PyTorch port against the JAX package, on the CPU.

- ``synthetic_cfd`` and the nonlinear Poisson samples equal JAX's to the bit
  (the same numpy and scipy from one seed);
- the Poisson losses against JAX's, the interior residual on a tiny FNOGNO
  (JAX differentiates each query point forward-mode, the port the batch of
  queries by autograd: the same numbers, each output depending on its own
  query only), its value and parameter gradients;
- ``train_gino_carcfd``, ``train_fnogno_carcfd`` and ``train_poisson`` (with
  and without the physics loss) on 2-epoch cuts of one training sample against the JAX scripts,
  each port script from the JAX run's initial weights (the scripts'
  ``PRNGKey(0)`` init, converted) and on the same samples: the car scripts'
  generator is monkeypatched in both packages to small bodies (96
  vertices, 8³ grids) at the scripts' full width, 1 + 1 samples;
- ``--data_source mini`` raises ``FileNotFoundError`` in both packages
  (``mini_car.pt`` is not in the repository).

Bounds: each script's final figures within 1e-5 relative of JAX's, the
per-epoch losses as JAX prints them (5 decimals); the losses within 1e-5 and
their gradients within 1e-4. Nothing is written into the JAX package: its
data directory holds the same files after each script test.
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuraloperator_tpu.data.datasets as jdatasets
from neuraloperator_tpu.data.datasets import nonlinear_poisson as jpoisson
from neuraloperator_tpu.data.datasets import synthetic_cfd as jcfd
from neuraloperator_tpu.losses import LpLoss as JLpLoss
from neuraloperator_tpu.losses import equation_losses as jeq
from neuraloperator_tpu.models import FNOGNO as JFNOGNO
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.data import datasets as tdatasets
from neuraloperator_tpu_torch.data.datasets import car_cfd_dataset as tcar
from neuraloperator_tpu_torch.data.datasets import nonlinear_poisson as tpoisson
from neuraloperator_tpu_torch.data.datasets import synthetic_cfd as tcfd
from neuraloperator_tpu_torch.losses import equation_losses as teq
from neuraloperator_tpu_torch.models import FNOGNO
from neuraloperator_tpu_torch.scripts import train_fnogno_carcfd as tfnogno
from neuraloperator_tpu_torch.scripts import train_gino_carcfd as tgino
from neuraloperator_tpu_torch.scripts import train_poisson as tpois

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_DATA = ROOT / "neuraloperator_tpu/data/datasets/data"
TOL, GRAD_TOL = 1e-5, 1e-4


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / f"scripts/{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _equal_samples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
            assert np.asarray(g[key]).dtype == np.asarray(w[key]).dtype, key


def test_synthetic_cfd_samples_equal_jax_to_the_bit():
    got = tcfd.load_synthetic_cfd(2, n_verts=300, grid_n=8, seed=4)
    _equal_samples(got, jcfd.load_synthetic_cfd(2, n_verts=300, grid_n=8, seed=4))
    assert got[0]["vertices"].shape == (300, 3) and got[0]["press"].shape == (1, 300)
    assert got[0]["distance"].shape == (8, 8, 8, 1)
    assert tdatasets.load_synthetic_cfd is tcfd.load_synthetic_cfd


def test_poisson_samples_and_processor_equal_jax_to_the_bit():
    got = tpoisson.NonlinearPoissonDataset(n_train=2, n_test=1, seed=3)
    want = jpoisson.NonlinearPoissonDataset(n_train=2, n_test=1, seed=3)
    _equal_samples([got.train_data[i] for i in range(2)] + [got.test_data[0]],
                   [want.train_data[i] for i in range(2)] + [want.test_data[0]])
    np.testing.assert_array_equal(tpoisson.generate_latent_queries(6, pad=1),
                                  jpoisson.generate_latent_queries(6, pad=1))
    for coefs in ({"seed": 2}, {"seed": 2, "r": 1.0}):
        np.testing.assert_array_equal(tpoisson.generate_output_queries(8, coefs),
                                      jpoisson.generate_output_queries(8, coefs))
    kw = dict(input_min=100, input_max=200, output_sub_level=0.5, seed=1)
    processed = tpoisson.PoissonGINODataProcessor(**kw).preprocess(got.train_data[0])
    expected = jpoisson.PoissonGINODataProcessor(**kw).preprocess(want.train_data[0])
    _equal_samples([processed], [expected])
    train, test, processor = tpoisson.load_nonlinear_poisson_pt(n_train=1, n_test=1)
    assert len(train) == len(test) == 1
    assert isinstance(processor, tpoisson.PoissonGINODataProcessor)


def test_mesh_archives_load_as_in_jax(tmp_path):
    samples = tcfd.load_synthetic_cfd(3, n_verts=64, grid_n=4)
    torch.save([{k: torch.from_numpy(v) for k, v in s.items()} for s in samples],
               tmp_path / "mini_car.pt")
    _equal_samples(tcar.load_mini_car(tmp_path), jdatasets.load_mini_car(tmp_path))
    got = tcar.CarCFDDataset(tmp_path, n_train=2, n_test=1, item_keys=["vertices", "press"])
    want = jdatasets.CarCFDDataset(tmp_path, n_train=2, n_test=1,
                                   item_keys=["vertices", "press"])
    _equal_samples([got.train_data[i] for i in range(2)] + [got.test_data[0]],
                   [want.train_data[i] for i in range(2)] + [want.test_data[0]])


def test_mini_source_raises_file_not_found_as_in_jax(monkeypatch):
    for script in (tgino, tfnogno):
        with pytest.raises(FileNotFoundError, match="mini_car.pt"):
            script.main(["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train_gino_carcfd.py"])
    with pytest.raises(FileNotFoundError, match="mini_car.pt"):
        _jax_script("train_gino_carcfd").main()


@pytest.fixture(scope="module")
def poisson_data():
    """One training and one test sample of the Poisson set (seed 0), made
    once: the packages' generators agree to the bit (above)."""
    return tpoisson.NonlinearPoissonDataset(n_train=1, n_test=1)


@pytest.fixture(scope="module")
def poisson_model(poisson_data):
    """A tiny 2-D FNOGNO (JAX's parameters, and the port's model holding
    them), a Poisson sample's gridded source and its queries."""
    kw = dict(in_channels=1, out_channels=1, gno_coord_dim=2, gno_radius=0.3,
              fno_n_modes=(4, 4), fno_hidden_channels=8, fno_n_layers=2, gno_max_neighbors=8,
              gno_embed_channels=4, gno_channel_mlp_hidden_layers=(16,))
    sample = poisson_data.train_data[0]
    f_grid, queries, y, src, nb = (a.numpy() if torch.is_tensor(a) else a
                                   for a in tpois.prep(sample, "cpu"))
    in_p = tpois.grid_points("cpu").numpy()
    jmodel = JFNOGNO(**kw)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(in_p),
                                  jnp.asarray(queries), jnp.asarray(f_grid))["params"]
    model = FNOGNO(**kw, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return dict(jmodel=jmodel, params=params, model=model, in_p=in_p, f=f_grid, q=queries,
                y=y, src=src, nb=nb)


def _interior_inputs(m, n=24):
    return m["q"][m["nb"]:m["nb"] + n], m["src"][:n]


def test_poisson_interior_loss_matches_jax(poisson_model):
    m = poisson_model
    q, src = _interior_inputs(m)
    in_p, f = jnp.asarray(m["in_p"]), jnp.asarray(m["f"])

    def jloss(p):
        return jeq.PoissonInteriorLoss()(
            lambda qq: m["jmodel"].apply({"params": p}, in_p, qq, f)[:, 0],
            output_queries=jnp.asarray(q), output_source_terms_domain=jnp.asarray(src))

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(m["params"])
    model = m["model"]
    model.zero_grad(set_to_none=True)
    tin, tf = torch.from_numpy(m["in_p"]), torch.from_numpy(m["f"])
    got = teq.PoissonInteriorLoss()(lambda qq: model(tin, qq, tf)[:, 0],
                                    output_queries=torch.from_numpy(q),
                                    output_source_terms_domain=torch.from_numpy(src))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    got.backward()
    flat = convert.flatten_flax(jgrads)
    for name, p in model.named_parameters():
        w = np.asarray(flat[name], np.float64)
        err = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err < GRAD_TOL, (name, err)


def test_poisson_interior_residual_equals_jax_pointwise(poisson_model):
    """The residual's parts at each point: the port's batched autograd
    against JAX's per-point grad and jacfwd."""
    m = poisson_model
    q, _ = _interior_inputs(m, 6)
    in_p, f = jnp.asarray(m["in_p"]), jnp.asarray(m["f"])

    def point(x):
        return m["jmodel"].apply({"params": m["params"]}, in_p, x[None], f)[0, 0]

    jgrad = np.asarray(jax.jit(jax.vmap(jax.grad(point)))(jnp.asarray(q)))
    jhess = np.asarray(jax.jit(jax.vmap(jax.jacfwd(jax.grad(point))))(jnp.asarray(q)))
    tq = torch.from_numpy(q).requires_grad_(True)
    u = m["model"](torch.from_numpy(m["in_p"]), tq, torch.from_numpy(m["f"]))[:, 0]
    du = torch.autograd.grad(u.sum(), tq, create_graph=True)[0]
    d2 = [torch.autograd.grad(du[:, i].sum(), tq, retain_graph=True)[0][:, i] for i in range(2)]
    np.testing.assert_allclose(du.detach().numpy(), jgrad, rtol=1e-4, atol=1e-5 * abs(jgrad).max())
    lap = (d2[0] + d2[1]).numpy()
    want = jhess[:, 0, 0] + jhess[:, 1, 1]
    np.testing.assert_allclose(lap, want, rtol=1e-4, atol=1e-5 * abs(want).max())


def test_poisson_boundary_and_equation_losses_match_jax(poisson_model):
    m = poisson_model
    q, src = _interior_inputs(m)
    pred = np.random.default_rng(5).standard_normal((1, len(m["q"]), 1)).astype(np.float32)
    y = m["y"][None]
    jb = jeq.PoissonBoundaryLoss()(jnp.asarray(pred), m["nb"], jnp.asarray(y), out_sub_level=0.5)
    tb = teq.PoissonBoundaryLoss()(torch.from_numpy(pred), m["nb"], torch.from_numpy(y),
                                   out_sub_level=0.5)
    np.testing.assert_allclose(float(tb), float(jb), rtol=1e-6)
    in_p, f = jnp.asarray(m["in_p"]), jnp.asarray(m["f"])
    want = jax.jit(lambda p: jeq.PoissonEqnLoss(boundary_weight=2.0, interior_weight=0.1)(
        lambda qq: m["jmodel"].apply({"params": p}, in_p, qq, f)[:, 0],
        jnp.asarray(pred), jnp.asarray(y), m["nb"], output_queries=jnp.asarray(q),
        output_source_terms_domain=jnp.asarray(src)))(m["params"])
    tin, tf = torch.from_numpy(m["in_p"]), torch.from_numpy(m["f"])
    got = teq.PoissonEqnLoss(boundary_weight=2.0, interior_weight=0.1)(
        lambda qq: m["model"](tin, qq, tf)[:, 0], torch.from_numpy(pred), torch.from_numpy(y),
        m["nb"], output_queries=torch.from_numpy(q),
        output_source_terms_domain=torch.from_numpy(src))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


@pytest.fixture
def jax_run(monkeypatch):
    """JAX's ``main`` of a script on argv; the JAX matmul precision its
    ``setup`` changes is restored afterwards, and its package's data
    directory must hold the same files after the run."""
    precision = jax.config.jax_default_matmul_precision
    before = sorted(p.name for p in JAX_DATA.iterdir())

    def run(module, argv):
        monkeypatch.setattr(sys, "argv", [f"{module.__name__}.py", *argv])
        return module.main()

    yield run
    jax.config.update("jax_default_matmul_precision", precision)
    assert sorted(p.name for p in JAX_DATA.iterdir()) == before


def _small_bodies(monkeypatch):
    """Both packages' car scripts draw 96-vertex bodies on 8³ grids."""
    def small(n_samples, **kwargs):
        rng = np.random.default_rng(0)
        return [jcfd.generate_cfd_sample(rng, n_verts=96, grid_n=8) for _ in range(n_samples)]

    monkeypatch.setattr(jdatasets, "load_synthetic_cfd", small)
    monkeypatch.setattr(tgino, "load_synthetic_cfd", small)
    return small


def _from_jax(module, params):
    build = module.build_model

    def load(*args, **kwargs):
        model = build(*args, **kwargs)
        model.load_state_dict(convert.convert_flax_params(params, model.state_dict(),
                                                          device="cpu"))
        return model

    return load


def _train_lines(text):
    return [float(v) for v in re.findall(r"^\[\d+\] (?:train l2|loss) (\S+)", text, re.M)]


CAR_ARGV = ["--data_source", "synthetic", "--n_train", "1", "--n_test", "1", "--n_epochs", "2",
            "--eval_interval", "1"]


@pytest.mark.parametrize("script", ["train_gino_carcfd", "train_fnogno_carcfd"])
def test_car_scripts_match_the_jax_scripts(jax_run, monkeypatch, capsys, script):
    samples = _small_bodies(monkeypatch)
    module = _jax_script(script)
    port = tgino if script == "train_gino_carcfd" else tfnogno
    argv = [*CAR_ARGV, "--latent_n", "8"] if port is tgino else CAR_ARGV
    trained = jax_run(module, argv)
    jax_out = capsys.readouterr().out
    # the JAX script's init (PRNGKey(0) on the first sample's shapes) and
    # its trained weights' test figure
    train, test = samples(2)[:1], samples(2)[1:]
    if port is tgino:
        lq = tgino.latent_queries(8)
        jm = module.GINO(in_channels=1, out_channels=1, fno_in_channels=1, gno_coord_dim=3,
                         in_gno_radius=0.25, out_gno_radius=0.25, fno_n_modes=(8, 8, 8),
                         fno_hidden_channels=32, fno_n_layers=4, gno_max_neighbors=32)
        batches = [[b.numpy() for b in tgino.prep(s, lq, "cpu")] for s in (*train, *test)]

        def apply(p, b):
            return jm.apply({"params": p}, *b[:4]).transpose(0, 2, 1), b[4].transpose(0, 2, 1)

        init_args = batches[0][:4]
    else:
        jm = module.FNOGNO(in_channels=1, out_channels=1, gno_coord_dim=3, gno_radius=0.25,
                           fno_n_modes=(8, 8, 8), fno_hidden_channels=32, fno_n_layers=4,
                           gno_max_neighbors=32, gno_batched=False)
        batches = [[b.numpy() for b in tfnogno.prep(s, "cpu")] for s in (*train, *test)]

        def apply(p, b):
            return jm.apply({"params": p}, *b[:3]).T[None], b[3].T[None]

        init_args = batches[0][:3]
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *map(jnp.asarray, init_args))["params"]
    l2 = JLpLoss(d=1)
    figure = jax.jit(lambda p, b: l2(*apply(p, b)))
    expected = float(np.mean([float(figure(trained, b)) for b in batches[1:]]))
    monkeypatch.setattr(port, "build_model", _from_jax(port, params))
    got = port.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    np.testing.assert_allclose(got["test_l2"], expected, rtol=TOL)
    assert float(re.findall(r"final test l2: (\S+)", jax_out)[-1]) == pytest.approx(
        float(re.findall(r"final test l2: (\S+)", out)[-1]), abs=1.01e-5)
    jtrain = _train_lines(jax_out)
    assert len(jtrain) == 2
    np.testing.assert_allclose(got["train_l2"], jtrain, rtol=0, atol=1.01e-5)
    jevals = [float(v) for v in re.findall(r"test l2 (\S+)$", jax_out, re.M)]
    np.testing.assert_allclose([got["evals"][e] for e in sorted(got["evals"])], jevals,
                               rtol=0, atol=1.01e-5)


@pytest.mark.parametrize("interior", [False, True])
def test_poisson_script_matches_the_jax_script(jax_run, monkeypatch, capsys, poisson_data,
                                               interior):
    argv = ["--n_train", "1", "--n_test", "1", "--n_epochs", "2"]
    if interior:
        argv += ["--interior_weight", "0.1", "--n_physics_points", "16"]
    module = _jax_script("train_poisson")
    for script in (module, tpois):
        monkeypatch.setattr(script, "NonlinearPoissonDataset", lambda **kw: poisson_data)
    jax_run(module, argv)
    jax_out = capsys.readouterr().out
    f0, q0, *_ = tpois.prep(poisson_data.train_data[0], "cpu")
    jm = module.FNOGNO(in_channels=1, out_channels=1, gno_coord_dim=2, gno_radius=0.2,
                       fno_n_modes=(8, 8), fno_hidden_channels=24, fno_n_layers=3,
                       gno_max_neighbors=16, gno_batched=False)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(tpois.grid_points("cpu")),
                              jnp.asarray(q0.numpy()), jnp.asarray(f0.numpy()))["params"]
    monkeypatch.setattr(tpois, "build_model", _from_jax(tpois, params))
    got = tpois.main([*argv, "--device", "cpu"])
    expected = [float(v) for v in re.findall(r"^test l2: (\S+)$", jax_out, re.M)]
    assert len(expected) == len(got["test_l2"]) == 1
    np.testing.assert_allclose(got["test_l2"], expected, rtol=TOL)
    np.testing.assert_allclose(got["train_loss"], _train_lines(jax_out), rtol=0,
                               atol=1.01e-5 * max(1.0, max(got["train_loss"])))
