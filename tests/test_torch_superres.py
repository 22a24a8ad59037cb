"""The port's super-resolution script against the JAX package's ``scripts/eval_ns_superres.py``.

The JAX script reads its trajectories from a fixed directory of the JAX
package, so its per-resolution computation is rebuilt here from its pieces
(``eval_batch``: the checkpoint's normalizers, the FNO, ``LpLoss`` and
``H1Loss`` with ``reduction="mean"``, each batch weighted by its length,
the ragged last batch kept). Both packages score one checkpoint (the
script's FNO at 4 modes and hidden 8, saved by the JAX package with its
``data_processor.json``) on tiny raw trajectories in ``tmp_path`` at 16²
and at the zero-shot resolutions 24² and 32², 7 pairs in batches of 3.

Tolerance: each figure ``rtol=1e-5`` (the same f32 forwards, with sums in
another order); the pair counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.data.datasets.ns_solver import trajectories_to_pairs
from neuraloperator_tpu.losses import H1Loss, LpLoss
from neuraloperator_tpu.models import fno as jfno
from neuraloperator_tpu.training import training_state as jts
from neuraloperator_tpu_torch.scripts import eval_ns_superres
from test_torch_rollout import _trajectories
from test_torch_trainer import _processors

torch.set_num_threads(1)

TOL = 1e-5
MAX_PAIRS, BATCH = 7, 3


def _jax_figures(model, params, dp, traj):
    """The JAX script's loop over one resolution's pairs."""
    xs, ys = trajectories_to_pairs(traj)
    xs, ys = xs[:MAX_PAIRS], ys[:MAX_PAIRS]
    l2, h1 = LpLoss(d=2, reduction="mean"), H1Loss(d=2, reduction="mean")

    @jax.jit
    def eval_batch(params, x, y):
        sample = dp.preprocess({"x": x}, train=False)
        out = model.apply({"params": params}, sample["x"])
        out, _ = dp.postprocess(out, sample, train=False)
        return l2(out, y), h1(out, y)

    tot_l2 = tot_h1 = n = 0.0
    for i in range(0, len(xs), BATCH):
        xb = jnp.asarray(xs[i:i + BATCH][:, None])
        yb = jnp.asarray(ys[i:i + BATCH][:, None])
        a, b = eval_batch(params, xb, yb)
        tot_l2 += float(a) * len(xb)
        tot_h1 += float(b) * len(xb)
        n += len(xb)
    return {"pairs": int(n), "rel_l2": tot_l2 / n, "rel_h1": tot_h1 / n}


@pytest.fixture
def checkpoint(tmp_path):
    """A checkpoint of the script's FNO and its normalizers, and raw test
    trajectories at 16², 24² and 32² (3 trajectories of 4 snapshots: 9 pairs,
    of which the first 7 are scored, in batches 3, 3, 1)."""
    model = jfno.FNO(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=8,
                     projection_channel_ratio=4)
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 1, 16, 16)))["params"]
    trajs = {res: _trajectories(10 + res, 3, 4, res=res) for res in (16, 24, 32)}
    train = trajs[16]
    _, jdp = _processors(train[:, :-1].reshape(-1, 1, 16, 16),
                         train[:, 1:].reshape(-1, 1, 16, 16))
    jts.save_training_state(tmp_path / "ckpt", "best_model", params, data_processor=jdp)
    raw = tmp_path / "data" / "ns_raw"
    raw.mkdir(parents=True)
    for res, traj in trajs.items():
        np.save(raw / f"nsforcing_traj_test_{res}.npy", traj)
    return tmp_path, model, params, jdp, trajs


def test_superres_figures_match_the_jax_script_with_a_ragged_tail(checkpoint, capsys):
    root, model, params, jdp, trajs = checkpoint
    got = eval_ns_superres.main([
        "--save_dir", str(root / "ckpt"), "--train_res", "16", "--eval_res", "[16,24,32,48]",
        "--max_pairs", str(MAX_PAIRS), "--batch", str(BATCH), "--n_modes", "4",
        "--hidden_channels", "8", "--data_dir", str(root / "data"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "using saved normalizers" in out
    # a missing resolution is reported and skipped, as the JAX script does
    assert "[48] missing nsforcing_traj_test_48.npy — generate with generate_ns_data.py " \
        "--res 48 --train-traj 0" in out
    assert set(got) == {16, 24, 32}
    for res, traj in trajs.items():
        want = _jax_figures(model, params, jdp, traj)
        assert got[res]["pairs"] == want["pairs"] == MAX_PAIRS
        for k in ("rel_l2", "rel_h1"):
            np.testing.assert_allclose(got[res][k], want[k], rtol=TOL, err_msg=f"{res} {k}")
        assert f"[{res}] pairs=7 rel_l2={got[res]['rel_l2']:.5f}" in out


def test_only_the_trajectories_the_pairs_need_are_read(checkpoint):
    """``load_pairs`` reads the first trajectories alone and gives the JAX
    script's first ``max_pairs`` pairs, with a channel axis."""
    root, _, _, _, trajs = checkpoint
    path = root / "data" / "ns_raw" / "nsforcing_traj_test_24.npy"
    for max_pairs in (2, 3, 7, 100):
        xs, ys = eval_ns_superres.load_pairs(path, max_pairs)
        want_x, want_y = trajectories_to_pairs(trajs[24])
        np.testing.assert_array_equal(xs[:, 0], want_x[:max_pairs])
        np.testing.assert_array_equal(ys[:, 0], want_y[:max_pairs])
