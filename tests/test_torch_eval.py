"""The port's evaluation entry point against the JAX protocol, on the CPU.

``evaluate`` and ``main`` of ``neuraloperator_tpu_torch.scripts.eval_ns_checkpoint``
are held to the loop of ``scripts/eval_ns_checkpoint.py`` computed with the
JAX package: the same small FNO (JAX init, its parameters carried across),
the same normalizers, ``LpLoss``/``H1Loss`` with ``reduction="mean"``, each
batch weighted by its length, the ragged tail dropped. Tolerance: 1e-6
relative on both figures (f32 forwards that agree to about 1e-6, then
float64 sums). On a split regenerated by each package's own solver the
pairs themselves differ by about 1e-6 relative (``tests/test_torch_ns_solver.py``),
so that case is held to 1e-4.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets import ns_solver as jns
from neuraloperator_tpu.data.transforms import DefaultDataProcessor as JaxProcessor
from neuraloperator_tpu.data.transforms import UnitGaussianNormalizer as JaxNormalizer
from neuraloperator_tpu.losses import H1Loss as JaxH1
from neuraloperator_tpu.losses import LpLoss as JaxLp
from neuraloperator_tpu.models import base_model as jbase
from neuraloperator_tpu.models import fno as jfno
from neuraloperator_tpu.training import training_state as jstate
from neuraloperator_tpu_torch.data.transforms import load_data_processor
from neuraloperator_tpu_torch.models import load_flagship
from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev

torch.set_num_threads(1)

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts/ns128_v2"
RTOL = 1e-6
RES = 16


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _small_flagship():
    meta = json.loads((FLAGSHIP / "model_metadata.json").read_text())
    meta["init_kwargs"].update(n_modes=[8, 8], hidden_channels=12, n_layers=2)
    return meta


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A JAX model saved as a training run: weights, architecture, normalizers."""
    root = tmp_path_factory.mktemp("run")
    meta = _small_flagship()
    model = jfno.FNO(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in meta["init_kwargs"].items()
        if not (isinstance(v, dict) and ("__callable__" in v or "__class__" in v))
    })
    params = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 1, RES, RES)))["params"]
    processor = JaxProcessor(JaxNormalizer(dim=[0, 2, 3]).fit(_rand(1, 16, 1, RES, RES, scale=0.8)),
                             JaxNormalizer(dim=[0, 2, 3]).fit(_rand(2, 16, 1, RES, RES, scale=0.9)))
    jbase.save_arch_metadata(model, root, "model")
    jstate.save_training_state(root, "best_model", params, epoch=1, data_processor=processor)
    return root, model, params, processor


def _jax_protocol(model, params, processor, xs, ys, batch):
    """The loop of scripts/eval_ns_checkpoint.py, verbatim in JAX."""
    l2, h1 = JaxLp(d=2, reduction="mean"), JaxH1(d=2, reduction="mean")

    @jax.jit
    def eval_batch(params, x, y):
        sample = processor.preprocess({"x": x}, train=False)
        out = model.apply({"params": params}, sample["x"])
        out, _ = processor.postprocess(out, sample, train=False)
        return l2(out, y), h1(out, y)

    tot_l2 = tot_h1 = n = 0.0
    for i in range(0, len(xs), batch):
        xb, yb = jnp.asarray(xs[i: i + batch]), jnp.asarray(ys[i: i + batch])
        if len(xb) < batch:
            break
        a, b = eval_batch(params, xb, yb)
        tot_l2 += float(a) * len(xb)
        tot_h1 += float(b) * len(xb)
        n += len(xb)
    return {"pairs": int(n), "rel_l2": tot_l2 / n, "rel_h1": tot_h1 / n}


def _assert_figures(actual, expected, rtol=RTOL):
    assert actual["pairs"] == expected["pairs"]
    for k in ("rel_l2", "rel_h1"):
        assert abs(actual[k] - expected[k]) <= rtol * abs(expected[k]), (k, actual, expected)


@pytest.mark.parametrize("n_pairs,batch", [(22, 4), (16, 16), (5, 2)])
def test_evaluate_matches_the_jax_protocol(run, n_pairs, batch):
    root, model, params, processor = run
    xs, ys = _rand(3, n_pairs, 1, RES, RES, scale=0.8), _rand(4, n_pairs, 1, RES, RES)
    port, port_processor, _ = load_flagship(root, device="cpu")
    actual = ev.evaluate(port, port_processor, xs, ys, batch, device="cpu")
    _assert_figures(actual, _jax_protocol(model, params, processor, xs, ys, batch))
    assert actual["pairs"] == n_pairs // batch * batch


def test_evaluate_needs_a_whole_batch(run):
    port, processor, _ = load_flagship(run[0], device="cpu")
    xs = _rand(3, 3, 1, RES, RES)
    with pytest.raises(ValueError, match="no whole batch"):
        ev.evaluate(port, processor, xs, xs, 4, device="cpu")


def test_main_reads_a_pt_split(run, tmp_path, capsys):
    root, model, params, processor = run
    xs, ys = _rand(6, 13, RES, RES, scale=0.8), _rand(7, 13, RES, RES)
    torch.save({"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)},
               tmp_path / f"nsforcing_test_{RES}.pt")
    result = ev.main(["--save_dir", str(root), "--res", str(RES), "--n_test", "10",
                      "--batch", "3", "--data_dir", str(tmp_path), "--device", "cpu"])
    expected = _jax_protocol(model, params, processor, xs[:10, None], ys[:10, None], 3)
    _assert_figures(result, expected)
    assert f"pairs=9 rel_l2={result['rel_l2']:.6f}" in capsys.readouterr().out


def test_main_takes_another_runs_normalizers(run, tmp_path):
    root, model, params, _ = run
    other = JaxProcessor(JaxNormalizer(dim=[0, 2, 3]).fit(_rand(8, 8, 1, RES, RES, scale=2.0)),
                         JaxNormalizer(dim=[0, 2, 3]).fit(_rand(9, 8, 1, RES, RES, scale=0.5)))
    (tmp_path / "data_processor.json").write_text(json.dumps(other.state_dict()))
    xs, ys = _rand(10, 8, RES, RES), _rand(11, 8, RES, RES)
    torch.save({"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)},
               tmp_path / f"nsforcing_test_{RES}.pt")
    result = ev.main(["--save_dir", str(root), "--normalizer_from", str(tmp_path),
                      "--res", str(RES), "--batch", "4", "--data_dir", str(tmp_path),
                      "--device", "cpu"])
    assert load_data_processor(tmp_path) is not None
    _assert_figures(result, _jax_protocol(model, params, other, xs[:, None], ys[:, None], 4))
    with pytest.raises(SystemExit, match="no data_processor.json"):
        ev.main(["--save_dir", str(root), "--normalizer_from", str(tmp_path / "none"),
                 "--device", "cpu"])


def test_main_regenerates_a_missing_split_in_memory(run, tmp_path, monkeypatch):
    """No .pt split: the seeded solver makes it in memory (here 2 trajectories
    of T = 3), and nothing is written."""
    root, model, params, processor = run
    solver = dict(visc=1e-3, T=3.0, dt=1e-3, record_dt=1.0)
    monkeypatch.setattr(ev, "TEST_TRAJECTORIES", 2)
    monkeypatch.setattr(ev, "SOLVER", solver)
    result = ev.main(["--save_dir", str(root), "--res", str(RES), "--batch", "2",
                      "--data_dir", str(tmp_path), "--device", "cpu"])
    assert list(tmp_path.iterdir()) == []

    traj = np.concatenate(list(jns.generate_nsforcing_trajectories(
        2, RES, seed=ev.TEST_SEED, **solver)))
    xs, ys = jns.trajectories_to_pairs(traj)
    perm = np.random.default_rng(ev.TEST_SEED + 1).permutation(len(xs))
    expected = _jax_protocol(model, params, processor, xs[perm][:, None], ys[perm][:, None], 2)
    assert expected["pairs"] == 6
    _assert_figures(result, expected, rtol=1e-4)


@pytest.mark.slow
def test_published_weights_score_alike_on_jax_and_port_made_pairs():
    """The first 2 trajectories of the flagship's test split (seed 10 000,
    50 000 steps of 128²), made on the CPU by the JAX solver and by the
    port's: every snapshot agrees to 1e-4 relative, and the published f16
    weights score the same on both pair sets to 1e-4 relative. Over the
    split's horizon the flow does not pull two float32 solvers apart."""
    from neuraloperator_tpu_torch.data.datasets import ns_solver as tns

    w0 = jns.gaussian_rf_vorticity(np.random.default_rng(ev.TEST_SEED),
                                   ev.TEST_TRAJECTORIES, 128)[:2]
    made = {
        "jax": np.asarray(jns.simulate_navier_stokes_2d(w0, **ev.SOLVER)),
        "port": tns.simulate_navier_stokes_2d(w0, device="cpu", **ev.SOLVER).numpy(),
    }
    gaps = [np.linalg.norm(made["port"][b, r] - made["jax"][b, r])
            / np.linalg.norm(made["jax"][b, r]) for b in range(2) for r in range(50)]
    model, processor, _ = load_flagship(FLAGSHIP, "best_model_f16", device="cpu")
    figures = {}
    for name, traj in made.items():
        xs, ys = jns.trajectories_to_pairs(np.concatenate([w0[:, None], traj], axis=1))
        figures[name] = ev.evaluate(model, processor, xs[:, None], ys[:, None], 16,
                                    device="cpu")
    print(f"largest snapshot gap {max(gaps):.3e}; figures {figures}")
    assert max(gaps) <= 1e-4
    _assert_figures(figures["port"], figures["jax"], rtol=1e-4)
