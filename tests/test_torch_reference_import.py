"""The checkpoint odds of the PyTorch port against the JAX package, on the
CPU: ``models/torch_import.py`` (reference neuralop state dicts onto the
port's ``state_dict``), ``save_checkpoint`` and ``partialclass``.

- ``torch_import``: for FNO (dense, and Tucker, CP and TT weights in
  tltorch's layouts), SFNO, UNO and GINO, a reference-layout state dict is
  written from a port model's own parameters (the inverse of the key
  patterns: Conv1d ``(out, in, 1)`` weights, complex or ``view_as_real``
  spectral weights, transposed ``Linear`` weights); the port's conversion
  gives back those parameters to the bit, and JAX's conversion of the same
  dict is the same tree. The reference-style dense FNO state dict of JAX's
  own test (``tests/test_torch_import.py``) converts in both packages to the
  same weights, whose forwards agree within 1e-5 relative l2; a checkpoint
  folder loads with its init kwargs; unknown keys raise.
- ``save_checkpoint``: the files are read by JAX's ``load_checkpoint`` into
  the same parameters to the bit, and by JAX's ``from_checkpoint``, and by
  the port's ``load_checkpoint``.
- ``partialclass`` keeps the JAX function's behaviour: new defaults, the
  other arguments as they were, an unknown field refused.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuraloperator_tpu.models import FNO as JFNO
from neuraloperator_tpu.models import base_model as jbase
from neuraloperator_tpu.models import torch_import as jimport
from neuraloperator_tpu_torch import convert
from neuraloperator_tpu_torch.models import (
    FNO,
    GINO,
    OTNO,
    SFNO,
    TFNO,
    UNO,
    from_checkpoint,
    load_checkpoint,
    partialclass,
    save_checkpoint,
)
from neuraloperator_tpu_torch.models import torch_import as timport
from tests.test_torch_import import HID, NM, _reference_style_state_dict

torch.set_num_threads(1)

TOL = 1e-5


def _small(cls, **kw):
    return cls(device="cpu", generator=torch.Generator().manual_seed(0), **kw)


FAMILIES = {
    "fno": lambda: _small(FNO, n_modes=(8, 8), in_channels=3, out_channels=1,
                          hidden_channels=8, n_layers=2, channel_mlp_skip="linear"),
    "tucker": lambda: _small(FNO, n_modes=(8, 8), in_channels=3, out_channels=1,
                             hidden_channels=8, n_layers=2, factorization="tucker", rank=0.5),
    "cp": lambda: _small(FNO, n_modes=(8, 8), in_channels=3, out_channels=1,
                         hidden_channels=8, n_layers=2, factorization="cp", rank=0.5),
    "tt": lambda: _small(FNO, n_modes=(8, 8), in_channels=3, out_channels=1,
                         hidden_channels=8, n_layers=2, factorization="tt", rank=0.5),
    "sfno": lambda: _small(SFNO, n_modes=(6, 6), in_channels=1, out_channels=1,
                           hidden_channels=8, n_layers=2),
    "uno": lambda: _small(UNO, in_channels=1, out_channels=1, hidden_channels=8,
                          lifting_channels=16, projection_channels=16, n_layers=3,
                          uno_out_channels=(8, 8, 8), uno_n_modes=((4, 4),) * 3,
                          uno_scalings=((1, 1), (0.5, 0.5), (2, 2)),
                          channel_mlp_skip="linear"),
    "gino": lambda: _small(GINO, in_channels=2, out_channels=1, gno_coord_dim=3,
                           in_gno_radius=0.6, out_gno_radius=0.6, fno_in_channels=2,
                           fno_n_modes=(2, 2, 2), fno_hidden_channels=4, fno_n_layers=1,
                           gno_max_neighbors=8, in_gno_channel_mlp_hidden_layers=(8,),
                           out_gno_channel_mlp_hidden_layers=(8,)),
}

_CONV1D = re.compile(r"^(?:(.*)\.)?(fno_skip|channel_mlp_skip|horizontal_skip)_(\d+)\.weight$")


def reference_key(name: str, value: torch.Tensor, layout: int):
    """The reference state-dict entry of a port parameter (the inverse of
    the key patterns); ``layout`` picks the complex layout of a spectral
    weight (0: complex, 1: ``view_as_real``)."""
    a = value.detach().numpy()
    key = re.sub(r"^block_(\d+)\.", r"fno_blocks.\1.", name)
    key = re.sub(r"(^|\.)conv_(\d+)\.", r"\1convs.\2.", key)
    key = re.sub(r"channel_mlp_(\d+)\.([wb])(\d+)$",
                 lambda m: f"channel_mlp.{m.group(1)}.fcs.{m.group(3)}."
                           + ("weight" if m.group(2) == "w" else "bias"), key)
    m = re.match(r"^(lifting|projection)\.([wb])(\d+)$", key)
    if m:
        key = f"{m.group(1)}.fcs.{m.group(3)}." + ("weight" if m.group(2) == "w" else "bias")
    if key.endswith(".weight") and re.search(r"\.fcs\.\d+\.weight$", key) and "gno" not in key:
        return key, a[..., None]
    m = _CONV1D.match(key)
    if m:
        plural = {"fno_skip": "fno_skips", "channel_mlp_skip": "channel_mlp_skips",
                  "horizontal_skip": "horizontal_skips"}[m.group(2)]
        base = f"{m.group(1)}.{plural}.{m.group(3)}" if m.group(1) else f"{plural}.{m.group(3)}"
        if a.ndim == 2:  # a linear skip: a Conv1d of kernel 1
            return f"{base}.conv.weight", a[..., None]
        return f"{base}.weight", a
    m = re.match(r"^(gno_in|gno_out)\.integral_transform\.channel_mlp\.fc(\d+)\.(kernel|bias)$",
                 key)
    if m:
        base = f"{m.group(1)}.integral_transform.channel_mlp.fcs.{m.group(2)}"
        return (f"{base}.weight", a.T) if m.group(3) == "kernel" else (f"{base}.bias", a)
    m = re.match(r"^(.*)\.w_(weight|core|lambdas|factor_(\d+))$", key)
    if m:
        field = {"weight": "weight.tensor", "core": "weight.core",
                 "lambdas": "weight.weights"}.get(m.group(2), f"weight.factors.{m.group(3)}")
        if layout == 0 and m.group(2) == "weight":
            return f"{m.group(1)}.{field}", a[0] + 1j * a[1]
        return f"{m.group(1)}.{field}", np.moveaxis(a, 0, -1).copy()
    m = re.match(r"^(.*)\.(fno_skip|channel_mlp_skip)_(\d+)\.bias$", key)
    if m:
        plural = m.group(2) + "s"
        return f"{m.group(1)}.{plural}.{m.group(3)}.bias", a
    return key, a


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reference_layouts_convert_onto_the_port_state(family):
    model = FAMILIES[family]()
    state = model.state_dict()
    layout = 1 if family == "sfno" else 0
    sd = {}
    for name, value in state.items():
        key, arr = reference_key(name, value, layout)
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    sd["_metadata"] = {"_version": "0.3.0"}
    got = timport.convert_dense_fno_state_dict(sd, model.state_dict())
    assert set(got) == set(state)
    for name, value in state.items():
        torch.testing.assert_close(got[name], value, rtol=0, atol=0, msg=name)
    plain = timport.convert_reference_state_dict(sd)
    assert all(plain[n].device.type == "cpu" and plain[n].dtype == torch.float32 for n in plain)
    jtree = convert.flatten_flax(jimport.convert_dense_fno_state_dict(sd))
    assert set(jtree) == set(plain)
    for name, arr in jtree.items():
        np.testing.assert_array_equal(plain[name].numpy(), np.asarray(arr), err_msg=name)
    model.load_state_dict(got)


def test_reference_fno_state_dict_forwards_as_in_jax(tmp_path):
    sd = _reference_style_state_dict(np.random.RandomState(0))
    jm = JFNO(n_modes=NM, in_channels=3, out_channels=1, hidden_channels=HID, n_layers=2,
              lifting_channel_ratio=2, projection_channel_ratio=2)
    template = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))["params"]
    params = jimport.convert_dense_fno_state_dict(sd, template)
    model = FNO(n_modes=NM, in_channels=3, out_channels=1, hidden_channels=HID, n_layers=2,
                lifting_channel_ratio=2, projection_channel_ratio=2, device="meta")
    state = timport.convert_dense_fno_state_dict(sd, model.state_dict())
    assert all(t.device.type == "cpu" for t in state.values())
    model = model.to_empty(device="cpu")
    model.load_state_dict(state)
    x = np.random.RandomState(1).randn(2, 3, 16, 16).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < TOL
    # a reference save_checkpoint folder
    torch.save(sd, tmp_path / "model_state_dict.pt")
    torch.save({"n_modes": NM, "_version": "0.3.0"}, tmp_path / "model_metadata.pkl")
    loaded, kwargs = timport.load_reference_fno_checkpoint(tmp_path, "model", model.state_dict())
    assert kwargs["n_modes"] == NM
    for name in state:
        torch.testing.assert_close(loaded[name], state[name], rtol=0, atol=0)
    (tmp_path / "model_metadata.pkl").unlink()
    assert timport.load_reference_fno_checkpoint(tmp_path, "model")[1] is None


def test_unknown_reference_keys_raise():
    with pytest.raises(ValueError, match="unconverted"):
        timport.convert_dense_fno_state_dict({"fno_blocks.some_unknown_module.0.weight":
                                              torch.zeros(3)})
    model = FAMILIES["fno"]()
    sd = {reference_key(n, v, 0)[0]: torch.from_numpy(np.ascontiguousarray(
        reference_key(n, v, 0)[1])) for n, v in model.state_dict().items()}
    del sd["lifting.fcs.0.bias"]
    with pytest.raises(ValueError, match="lifting.b0"):
        timport.convert_dense_fno_state_dict(sd, model.state_dict())


@pytest.mark.parametrize("cls,kwargs,shape", [
    (FNO, dict(n_modes=(4, 4), in_channels=2, out_channels=1, hidden_channels=8,
               n_layers=2), (1, 2, 8, 8)),
    (TFNO, dict(n_modes=(4, 4), in_channels=2, out_channels=1, hidden_channels=8,
                n_layers=2, weight_dtype="bfloat16"), (1, 2, 8, 8)),
    (OTNO, dict(n_modes=(4, 4), in_channels=6, hidden_channels=8, n_layers=2), None),
])
def test_save_checkpoint_is_read_by_jax_and_the_port(tmp_path, cls, kwargs, shape):
    model = _small(cls, **kwargs)
    path = save_checkpoint(model, tmp_path, "model")
    assert path == tmp_path / "model_state_dict.msgpack"
    jm = jbase.from_checkpoint(tmp_path, "model")
    assert type(jm).__name__ == cls.__name__
    if shape is None:
        init_args = (jnp.zeros((1, 6, 8, 8)), jnp.zeros((10,), jnp.int32))
    else:
        init_args = (jnp.zeros(shape),)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *init_args))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), template)
    restored = jbase.load_checkpoint(jm, template, tmp_path, "model")
    flat = convert.flatten_flax(restored["params"])
    state = model.state_dict()
    assert set(flat) == set(state)
    for name, value in state.items():
        np.testing.assert_array_equal(convert.as_tensor(flat[name]).float().numpy(),
                                      value.float().numpy(), err_msg=name)
    again = from_checkpoint(tmp_path, "model", device="cpu")
    load_checkpoint(again, tmp_path, "model")
    for name, value in again.state_dict().items():
        torch.testing.assert_close(value, state[name], rtol=0, atol=0)


def test_partialclass_sets_new_defaults_as_in_jax():
    MyFNO = partialclass("MyFNO", FNO, factorization="tucker", rank=0.05, hidden_channels=8)
    assert MyFNO.__name__ == "MyFNO" and issubclass(MyFNO, FNO)
    model = MyFNO((4, 4), 1, 1, n_layers=1, device="cpu")
    assert model._init_kwargs["factorization"] == "tucker"
    assert model._init_kwargs["rank"] == 0.05 and model._init_kwargs["hidden_channels"] == 8
    assert model.fno_blocks.conv_0.w_core.shape[0] == 2
    override = MyFNO((4, 4), 1, 1, hidden_channels=4, factorization=None, n_layers=1,
                     device="cpu")
    assert override.fno_blocks.conv_0.w_weight.shape[1:3] == (4, 4)
    with pytest.raises(TypeError, match="has no field 'bogus'"):
        partialclass("Bad", FNO, bogus=1)
    from neuraloperator_tpu.models.fno import partialclass as jpartialclass

    jcls = jpartialclass("MyFNO", JFNO, factorization="tucker", rank=0.05, hidden_channels=8)
    jax_partial = jcls(n_modes=(4, 4), in_channels=1, out_channels=1, n_layers=1)
    assert (jax_partial.factorization, jax_partial.rank, jax_partial.hidden_channels) == (
        "tucker", 0.05, 8)
    with pytest.raises(TypeError, match="has no field 'bogus'"):
        jpartialclass("Bad", JFNO, bogus=1)
