"""The port's modules around optional packages, against the JAX package, with
no network and none of the packages installed: ``ZarrDataset`` on a stub
``zarr``, ``web_utils`` on ``file://`` URLs and a monkeypatched ``urlopen``,
the ``Trainer``'s wandb logging and the wandb helpers on a stub ``wandb``
(``tests/test_trainer.py``'s), and the small helpers
``reference_weight_slice``, ``to_real_storage`` and ``to_complex``. Every
comparison is to the bit: nothing here rounds differently.
"""

import hashlib
import io
import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


# ----------------------------------------------------------------------- zarr


class _Array(np.ndarray):
    attrs = {"units": "m/s"}


def _stub_zarr(store):
    class _Root(dict):
        shape = store["x"].shape

    module = types.ModuleType("zarr")
    module.open = lambda filename, mode="r": _Root(store)
    return module


@pytest.mark.parametrize("resolution", [128, 256])
def test_zarr_dataset_matches_jax_on_a_stub_store(monkeypatch, resolution):
    """Samples subsampled from the stored 1024 grid (256 here, so 128 -> 32
    points, 256 -> 64), a channel axis added, the transforms applied, the
    attributes read, an index past the end refused; an unknown resolution
    raises ValueError."""
    from neuraloperator_tpu.data.datasets import zarr_dataset as jz
    from neuraloperator_tpu_torch.data.datasets import zarr_dataset as tz

    rng = np.random.default_rng(0)
    store = {k: rng.standard_normal((3, 256, 256)).view(_Array) for k in ("x", "y")}
    for module in (jz, tz):
        monkeypatch.setattr(module, "zarr", _stub_zarr(store))
        monkeypatch.setattr(module, "_HAS_ZARR", True)
    kw = dict(resolution=resolution, transform_x=lambda a: 2 * a)
    ours, ref = tz.ZarrDataset("store.zarr", **kw), jz.ZarrDataset("store.zarr", **kw)
    assert len(ours) == len(ref) == 3
    for i in range(3):
        for k in ("x", "y"):
            np.testing.assert_array_equal(ours[i][k], ref[i][k])
        assert ours[i]["x"].dtype == np.float32
    assert ours.attrs("x", "units") == ref.attrs("x", "units") == "m/s"
    assert len(tz.ZarrDataset("store.zarr", n_samples=2)) == 2
    with pytest.raises(IndexError):
        ours[3]
    with pytest.raises(ValueError, match="resolution"):
        tz.ZarrDataset("store.zarr", resolution=100)


def test_zarr_dataset_raises_without_zarr(monkeypatch):
    from neuraloperator_tpu.data.datasets import zarr_dataset as jz
    from neuraloperator_tpu_torch.data.datasets import zarr_dataset as tz

    monkeypatch.setattr(tz, "_HAS_ZARR", False)
    monkeypatch.setattr(jz, "_HAS_ZARR", False)
    with pytest.raises(ImportError, match="zarr") as ours:
        tz.ZarrDataset("store.zarr")
    with pytest.raises(ImportError) as ref:
        jz.ZarrDataset("store.zarr")
    assert str(ours.value) == str(ref.value)


# ------------------------------------------------------------------ web_utils


def test_download_from_a_file_url_matches_jax(tmp_path):
    """A ``file://`` URL is copied, its md5 checked (matching: kept;
    mismatching: deleted and ValueError), and the md5 helpers agree."""
    from neuraloperator_tpu.data.datasets import web_utils as jw
    from neuraloperator_tpu_torch.data.datasets import web_utils as tw

    src = tmp_path / "source.bin"
    src.write_bytes(bytes(range(256)) * 50)
    md5 = hashlib.md5(src.read_bytes()).hexdigest()
    for name, module in (("ours", tw), ("ref", jw)):
        dest = module.download_from_url(src.as_uri(), tmp_path / name / "copy.bin", md5=md5)
        assert dest.read_bytes() == src.read_bytes()
        assert module.calculate_md5(dest, chunk_size=1000) == md5
        assert module.check_md5(dest, md5) and module.check_integrity(dest, md5)
        assert module.check_integrity(dest) and not module.check_integrity(tmp_path / "none")
        bad = tmp_path / name / "bad.bin"
        with pytest.raises(ValueError, match="md5 mismatch"):
            module.download_from_url(src.as_uri(), bad, md5="0" * 32)
        assert not bad.exists()


def test_offline_downloads_raise_connection_error(monkeypatch, tmp_path):
    """Where ``urlopen`` cannot connect, both functions raise
    ``ConnectionError``, which names the port's synthetic generators."""
    from neuraloperator_tpu_torch.data.datasets import web_utils as tw

    def offline(url, timeout=None):
        raise OSError("network is unreachable")

    monkeypatch.setattr(tw.urllib.request, "urlopen", offline)
    with pytest.raises(ConnectionError, match="offline environment") as e:
        tw.download_from_url("https://zenodo.org/records/1/files/a.pt", tmp_path / "a.pt")
    assert "neuraloperator_tpu_torch.data.datasets.synthetic" in str(e.value)
    assert "neuraloperator_tpu." not in str(e.value)
    with pytest.raises(ConnectionError, match="Zenodo record 12345"):
        tw.download_from_zenodo_record("12345", tmp_path)


def test_zenodo_record_served_by_a_stub_urlopen_matches_jax(monkeypatch, tmp_path):
    """A record of three files served by a monkeypatched ``urlopen``: the
    selected files downloaded and md5-checked, in the record's order, by
    both packages."""
    from neuraloperator_tpu.data.datasets import web_utils as jw
    from neuraloperator_tpu_torch.data.datasets import web_utils as tw

    files = {f"f{i}.pt": bytes([i]) * (100 + i) for i in range(3)}
    base = "https://zenodo.org/api/records/777"
    record = {"files": [{"key": k, "links": {"self": f"{base}/files/{k}"},
                         "checksum": "md5:" + hashlib.md5(v).hexdigest()}
                        for k, v in files.items()]}
    asked = []

    def urlopen(url, timeout=None):
        asked.append(url)
        body = json.dumps(record).encode() if url == base else files[url.rsplit("/", 1)[1]]
        return io.BytesIO(body)

    for name, module in (("ours", tw), ("ref", jw)):
        monkeypatch.setattr(module.urllib.request, "urlopen", urlopen)
        asked.clear()
        out = module.download_from_zenodo_record("777", tmp_path / name, ["f0.pt", "f2.pt"])
        assert [p.name for p in out] == ["f0.pt", "f2.pt"]
        assert all(p.read_bytes() == files[p.name] for p in out)
        assert asked == [base, f"{base}/files/f0.pt", f"{base}/files/f2.pt"]


# ---------------------------------------------------------------------- wandb


def _stub_wandb(logged):
    stub = types.ModuleType("wandb")

    class _Img:
        def __init__(self, arr):
            self.arr = np.asarray(arr)
            self.shape = self.arr.shape

    stub.Image = _Img
    stub.log = lambda payload, step=None: logged.setdefault(step, payload)
    stub.login = lambda key=None: logged.setdefault("key", key)
    return stub


def _trainers(wandb_log, log_output):
    """The port's and JAX's Trainer on one FNO from the same weights."""
    import jax

    from neuraloperator_tpu.models import FNO as JFNO
    from neuraloperator_tpu.training import Trainer as JTrainer
    from neuraloperator_tpu_torch import convert
    from neuraloperator_tpu_torch.models import FNO
    from neuraloperator_tpu_torch.training import Trainer

    kw = dict(n_modes=(4, 4), in_channels=1, out_channels=1, hidden_channels=8, n_layers=1)
    params = JFNO(**kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 8, 8)))["params"]
    model = FNO(**kw, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    jtrainer = JTrainer(model=JFNO(**kw), n_epochs=1, wandb_log=wandb_log,
                        log_output=log_output)
    jtrainer.params = params
    return (Trainer(model=model, n_epochs=1, device="cpu", wandb_log=wandb_log,
                    log_output=log_output), jtrainer)


def _train(trainer, jax_side):
    from neuraloperator_tpu.data.datasets import DataLoader as JLoader
    from neuraloperator_tpu.data.datasets import TensorDataset as JTensors
    from neuraloperator_tpu.losses import LpLoss as JLp
    from neuraloperator_tpu.training import adamw as jadamw
    from neuraloperator_tpu_torch.data.datasets import DataLoader, TensorDataset
    from neuraloperator_tpu_torch.losses import LpLoss
    from neuraloperator_tpu_torch.training import adamw

    x = np.random.RandomState(0).randn(16, 1, 8, 8).astype(np.float32)
    if jax_side:
        loader = JLoader(JTensors(x, 2 * x), 8)
        return trainer.train(loader, {"t": loader}, jadamw(1e-3), training_loss=JLp(d=2),
                             eval_losses={"l2": JLp(d=2)})
    loader = DataLoader(TensorDataset(x, 2 * x), 8)
    return trainer.train(loader, {"t": loader}, adamw(1e-3), training_loss=LpLoss(d=2),
                         eval_losses={"l2": LpLoss(d=2)})


def test_wandb_logs_metrics_and_the_output_image_as_jax(monkeypatch):
    """``wandb_log=True, log_output=True`` with a stub ``wandb``: after the
    evaluation both Trainers log the metrics, ``train_err`` and the first
    prediction's first channel scaled to [0, 1] as an image, at the
    epoch's step."""
    logged, jlogged = {}, {}
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(logged))
    ours = _trainers(True, True)[0]
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(jlogged))
    ref = _trainers(True, True)[1]
    assert ours.wandb_log and ref.wandb_log
    _train(ours, False)
    _train(ref, True)
    assert set(logged[0]) == set(jlogged[0]) == {"t_l2", "train_err", "eval_output"}
    for k in ("t_l2", "train_err"):
        np.testing.assert_allclose(logged[0][k], jlogged[0][k], rtol=1e-5)
    img, jimg = logged[0]["eval_output"], jlogged[0]["eval_output"]
    assert img.shape == jimg.shape == (8, 8)
    assert img.arr.min() == 0 and abs(img.arr.max() - 1) < 1e-6
    np.testing.assert_allclose(img.arr, jimg.arr, rtol=0, atol=1e-5)
    # without log_output: the metrics alone
    logged.clear()
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(logged))
    _train(_trainers(True, False)[0], False)
    assert set(logged[0]) == {"t_l2", "train_err"}


def test_wandb_log_turns_off_without_wandb(monkeypatch):
    """Without the package both Trainers turn wandb logging off and train."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    ours, ref = _trainers(True, True)
    assert not ours.wandb_log and not ref.wandb_log
    assert np.isfinite(_train(ours, False)["t_l2"])


def test_wandb_helpers_match_jax(monkeypatch, tmp_path):
    """The key from the environment, else from the file, else None; setting
    it from the file; logging in with a stub wandb, and False without it or
    without a key."""
    from neuraloperator_tpu import utils as jutils
    from neuraloperator_tpu_torch import utils as tutils
    from neuraloperator_tpu_torch.scripts import login_wandb

    keyfile = tmp_path / "key.txt"
    keyfile.write_text("file-key\n")
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    for module in (tutils, jutils):
        assert module.get_wandb_api_key(tmp_path / "none.txt") is None
        assert module.get_wandb_api_key(keyfile) == "file-key"
    monkeypatch.setenv("WANDB_API_KEY", "env-key")
    assert tutils.get_wandb_api_key(keyfile) == jutils.get_wandb_api_key(keyfile) == "env-key"
    monkeypatch.delenv("WANDB_API_KEY")
    tutils.set_wandb_api_key(tmp_path / "none.txt")
    assert "WANDB_API_KEY" not in __import__("os").environ
    tutils.set_wandb_api_key(keyfile)
    assert __import__("os").environ["WANDB_API_KEY"] == "file-key"
    monkeypatch.delenv("WANDB_API_KEY")
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert tutils.wandb_login(keyfile) is jutils.wandb_login(keyfile) is False
    logged = {}
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(logged))
    assert tutils.wandb_login(tmp_path / "none.txt") is False
    assert tutils.wandb_login(keyfile) is True and logged["key"] == "file-key"
    monkeypatch.setenv("WANDB_API_KEY", "env-key")
    assert login_wandb.main() is True and logged["key"] == "file-key"


# --------------------------------------------------------------- small helpers


def test_small_helpers_match_jax():
    from neuraloperator_tpu.layers import spectral_convolution as jsc
    from neuraloperator_tpu.ops import fourier as jf
    from neuraloperator_tpu_torch.layers import spectral_convolution as tsc
    from neuraloperator_tpu_torch.ops import fourier as tf

    for start in range(0, 6):
        for last in (False, True):
            assert tf.reference_weight_slice(start, last) == jf.reference_weight_slice(start,
                                                                                        last)
    rng = np.random.default_rng(3)
    c = (rng.standard_normal((3, 4, 5)) + 1j * rng.standard_normal((3, 4, 5))).astype(
        np.complex64)
    stored = tsc.to_real_storage(torch.from_numpy(c))
    np.testing.assert_array_equal(stored.numpy(), np.asarray(jsc.to_real_storage(jnp.asarray(c))))
    back = tsc.to_complex(stored)
    assert back.dtype == torch.complex64
    np.testing.assert_array_equal(back.numpy(), np.asarray(jsc.to_complex(jnp.asarray(
        stored.numpy()))))
    np.testing.assert_array_equal(back.numpy(), c)
