"""The port's int8 serving and exported forwards against the JAX package's,
on the CPU at a small size.

A flagship-shaped FNO (hidden 8, 8x6 modes, 2 layers) with the flagship's
normalizers in both packages, the same weights. Tolerances: int8 codes,
scales and dequantized bf16 weights equal to JAX's to the bit (the same f32
division, multiplication and half-to-even rounding); served and exported
answers within relative l2 1e-5 of JAX's (f32 sums in another order over
the same bf16 weights; 2.5e-7 measured); an exported forward against the
port's eager forward on the same weights: bit for bit (the artifact records
the same ops). The JAX artifact is exported as the JAX package's own tests
export it, with its default contraction backend (a symbolic batch does not
trace through the Pallas interpreter); ``CompiledForward`` runs the Pallas
kernel in interpret mode.
"""

import functools
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from neuraloperator_tpu import serving as jserving
from neuraloperator_tpu.data.transforms.data_processors import (
    load_data_processor as jax_load_data_processor,
)
from neuraloperator_tpu.models import fno as jfno
from neuraloperator_tpu.ops.contractions import set_contraction_backend
from neuraloperator_tpu_torch import convert, serving
from neuraloperator_tpu_torch.data.transforms import load_data_processor
from neuraloperator_tpu_torch.models import model_from_metadata, save_arch_metadata
from neuraloperator_tpu_torch.scripts import serve_model
from neuraloperator_tpu_torch.training import save_training_state

torch.set_num_threads(1)

FLAGSHIP = Path(__file__).resolve().parents[1] / "artifacts/ns128_v2"
TOL = 1e-5
RES = (16, 17)


@pytest.fixture
def jax_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    set_contraction_backend("pallas")
    yield
    set_contraction_backend("auto")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pair():
    """The small FNO in both packages with the same weights."""
    meta = json.loads((FLAGSHIP / "model_metadata.json").read_text())
    meta["init_kwargs"].update(n_modes=[8, 6], hidden_channels=8, n_layers=2)
    jmodel = jfno.FNO(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in meta["init_kwargs"].items() if not isinstance(v, dict)})
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, *RES)))["params"]
    model = model_from_metadata(meta, device="cpu")
    model.load_state_dict(convert.convert_flax_params(params, model.state_dict(), device="cpu"))
    return jmodel, params, model


def _normalizers():
    dp, jdp = load_data_processor(FLAGSHIP), jax_load_data_processor(FLAGSHIP)
    return ({"preprocess_fn": dp.in_normalizer.transform,
             "postprocess_fn": dp.out_normalizer.inverse_transform},
            {"preprocess_fn": jdp.in_normalizer.transform,
             "postprocess_fn": jdp.out_normalizer.inverse_transform})


def _edge_leaves():
    """Leaves at the threshold's edges: exactly 4096 elements (quantized),
    4095 (kept), bf16, 1-d, a zero row (the 1e-30 floor) and an int leaf."""
    zero_row = _rand(3, 64, 70)
    zero_row[5] = 0.0
    leaves = {"at": _rand(1, 64, 64), "below": _rand(2, 4095), "zero_row": zero_row,
              "flat": _rand(4, 5000), "bf16": _rand(5, 2, 64, 33), "ints": np.arange(5000)}
    port = {k: torch.from_numpy(v) for k, v in leaves.items()}
    port["bf16"] = port["bf16"].to(torch.bfloat16)
    jax_tree = {k: jnp.asarray(v) for k, v in leaves.items()}
    jax_tree["bf16"] = jax_tree["bf16"].astype(jnp.bfloat16)
    return port, jax_tree


def _as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("case", ["small_fno", "edge_leaves"])
def test_int8_codes_scales_and_dequantized_weights_equal_jax(case):
    if case == "small_fno":
        _, params, model = _pair()
        port, jax_tree = model.state_dict(), params
    else:
        port, jax_tree = _edge_leaves()
    got = serving.quantize_params_int8(port)
    want = convert.flatten_flax(jax.tree_util.tree_map(
        lambda x: x, jserving.quantize_params_int8(jax_tree),
        is_leaf=lambda x: isinstance(x, tuple)))
    assert set(got) == set(want)
    for name, (codes, scale) in got.items():
        j_codes, j_scale = want[name]
        assert (scale is None) == (j_scale is None), name
        if scale is not None:
            assert codes.dtype == torch.int8, name
            np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes), err_msg=name)
            np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale), err_msg=name)
    quantized = {k for k, (_, s) in got.items() if s is not None}
    if case == "edge_leaves":
        assert quantized == {"at", "zero_row", "flat", "bf16"}
    else:  # the spectral weights; the 8x8 linear skips and the MLPs are below 4096
        assert quantized == {"fno_blocks.conv_0.w_weight", "fno_blocks.conv_1.w_weight"}
    deq = serving.dequantize_params(got)
    j_deq = convert.flatten_flax(jserving.dequantize_params(jserving.quantize_params_int8(
        jax_tree)))
    for name, t in deq.items():
        if name in quantized:
            assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_as_np(t), np.asarray(j_deq[name], np.float32),
                                      err_msg=name)


def test_int8_serving_matches_jax(jax_pallas):
    """``CompiledForward(quantize="int8")`` keeps the codes, the scales and
    the small leaves, nothing else, and answers as the JAX class does."""
    jmodel, params, model = _pair()
    fns, jfns = _normalizers()
    example = torch.zeros(1, 1, *RES)
    served = serving.CompiledForward(model, example, batch_sizes=(1, 4), quantize="int8",
                                     device="cpu", **fns)
    jserved = jserving.CompiledForward(jmodel, params, jnp.zeros((1, 1, *RES)),
                                       batch_sizes=(1, 4), quantize="int8", **jfns)
    assert {p.device.type for p in served.model.parameters()} == {"meta"}
    assert served._params["fno_blocks.conv_0.w_weight"][0].dtype == torch.int8
    for n, seed in ((1, 1), (3, 2)):
        x = _rand(seed, n, 1, *RES)
        got = served(torch.from_numpy(x))
        assert got.shape == (n, 1, *RES)
        assert _rel_l2(got.numpy(), np.asarray(jserved(jnp.asarray(x)))) <= TOL
    with pytest.raises(ValueError, match="unsupported quantize='int4'"):
        serving.CompiledForward(model, example, quantize="int4", device="cpu")
    # a mesh is ported (tests/test_torch_mesh.py); its buckets must split
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="not divisible by the 2 data ranks"):
        serving.CompiledForward(model, example, mesh=SimpleNamespace(shape={"data": 2}),
                                device="cpu", quantize="int8")


@pytest.mark.parametrize("polymorphic", [True, False], ids=["symbolic-batch", "fixed-shape"])
def test_exported_forward_matches_jax_and_the_eager_forward(polymorphic, tmp_path):
    """The artifact (weights and normalizers baked in) answers as JAX's
    exported forward does, and as the port's eager forward to the bit, with
    TF32 switched on by the caller (the artifact runs its matmuls with it
    off, as the eager forward does by default)."""
    jmodel, params, model = _pair()
    fns, jfns = _normalizers()
    example = torch.zeros(2, 1, *RES)
    path = tmp_path / "fno.pt2"
    blob = serving.export_forward(model, example, path=path, polymorphic_batch=polymorphic,
                                  **fns)
    assert path.read_bytes() == blob
    forward = serving.load_exported(path)
    j_forward = jserving.load_exported(jserving.export_forward(
        jmodel, params, jnp.zeros((2, 1, *RES)), polymorphic_batch=polymorphic, **jfns))
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        for n in ((1, 3) if polymorphic else (2,)):
            x = _rand(n, n, 1, *RES)
            got = forward(torch.from_numpy(x))
            assert flags.allow_tf32
            assert _rel_l2(got.numpy(), np.asarray(j_forward(jnp.asarray(x)))) <= TOL
            with torch.no_grad():
                eager = fns["postprocess_fn"](model(fns["preprocess_fn"](torch.from_numpy(x))))
            assert torch.equal(got, eager)
    finally:
        flags.allow_tf32 = saved
    if not polymorphic:
        with pytest.raises((AssertionError, RuntimeError)):  # a guard on the batch size
            forward(torch.from_numpy(_rand(3, 3, 1, *RES)))


def _graph_targets(blob):
    program = torch.export.load(io.BytesIO(blob))
    return [str(node.target) for node in program.graph.nodes if node.op == "call_function"]


def test_exported_graph_calls_the_contraction_operator():
    """One node of the port's contraction operator per spectral layer (the
    op that launches K1 on the card), and no einsum in its place."""
    _, _, model = _pair()
    targets = _graph_targets(serving.export_forward(model, torch.zeros(1, 1, *RES)))
    assert targets.count("neuraloperator_tpu_torch.mode_contraction.default") == 2
    assert not [t for t in targets if "einsum" in t]
    with pytest.raises(ValueError, match="platforms"):
        serving.export_forward(model, torch.zeros(1, 1, *RES), platforms=("tpu",))
    with pytest.raises(ValueError, match="platforms"):
        serving.export_forward(model, torch.zeros(1, 1, *RES), platforms=("cuda", "cpu"))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_serve_model_export_writes_an_artifact_that_answers(tmp_path, capsys, bf16):
    """``serve_model --export PATH`` on a Trainer-layout checkpoint: the
    artifact holds the served weights (bf16 under ``--bf16``) and the saved
    normalizers, and answers a ragged batch as the served endpoint does."""
    _, _, model = _pair()
    save_training_state(tmp_path, "model", model.state_dict())
    save_arch_metadata(model, tmp_path, "model")
    (tmp_path / "data_processor.json").write_text((FLAGSHIP / "data_processor.json").read_text())
    path = tmp_path / "served.pt2"
    result = serve_model.main(["--ckpt_dir", str(tmp_path), "--name", "model", "--shape",
                               f"[1,{RES[0]},{RES[1]}]", "--buckets", "[1,4]", "--bf16",
                               str(bf16).lower(), "--probe_iters", "1", "--export", str(path),
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"-> {path}" in out and "exported" in out
    assert result["export_mb"] == pytest.approx(path.stat().st_size / 1e6)
    fns, _ = _normalizers()
    served = serving.CompiledForward(model, torch.zeros(1, 1, *RES), batch_sizes=(3,),
                                     param_dtype=torch.bfloat16 if bf16 else None,
                                     device="cpu", **fns)
    x = torch.from_numpy(_rand(9, 3, 1, *RES))
    got = serving.load_exported(path)(x)
    assert torch.isfinite(got).all()
    assert torch.equal(got, served(x))


@pytest.mark.slow
def test_chip_smoke_int8_bounds_are_jax_figures():
    """``chip_smoke.py`` bounds the card's int8 evaluation of the published
    weights by twice the JAX package's int8 figures for them: JAX's
    ``CompiledForward(quantize="int8")`` on the CPU over the test split's 40
    first-record pairs (each trajectory's w0 -> w(1), the split's seed and
    solver; the other pairs need 50 000 solver steps per trajectory). This
    recomputes them (~30 s): the figures to 4 digits, the published weights
    being the f16 copy widened to f32 and the normalizers the checkpoint's."""
    import importlib.util

    from neuraloperator_tpu.losses import data_losses as jl
    from neuraloperator_tpu_torch.data.datasets import ns_solver
    from neuraloperator_tpu_torch.models import load_flagship
    from neuraloperator_tpu_torch.scripts import eval_ns_checkpoint as ev

    spec = importlib.util.spec_from_file_location("chip_smoke", FLAGSHIP.parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model, _, _ = load_flagship(FLAGSHIP, "best_model_f16", device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, convert.to_flax_params(model.state_dict()))
    meta = json.loads((FLAGSHIP / "model_metadata.json").read_text())
    jmodel = jfno.FNO(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in meta["init_kwargs"].items() if not isinstance(v, dict)})
    w0 = ns_solver.gaussian_rf_vorticity(np.random.default_rng(ev.TEST_SEED),
                                         ev.TEST_TRAJECTORIES, 128)
    record = {k: v for k, v in ev.SOLVER.items() if k != "T"}
    w1 = ns_solver.simulate_navier_stokes_2d(w0, T=ev.SOLVER["record_dt"], device="cpu",
                                             **record).numpy()
    xs, ys = np.asarray(w0, np.float32)[:, None], np.asarray(w1[:, 0], np.float32)[:, None]
    _, jfns = _normalizers()
    served = jserving.CompiledForward(jmodel, params, jnp.zeros((8, 1, 128, 128)),
                                      batch_sizes=(8,), quantize="int8", **jfns)
    l2, h1 = jl.LpLoss(d=2, reduction="mean"), jl.H1Loss(d=2, reduction="mean")
    figures = np.mean([[float(l2(out, y)), float(h1(out, y))]
                       for out, y in ((served(jnp.asarray(xs[i:i + 8])), jnp.asarray(ys[i:i + 8]))
                                      for i in range(0, len(xs), 8))], axis=0)
    np.testing.assert_allclose(figures, [smoke.INT8_L2_BOUND / 2, smoke.INT8_H1_BOUND / 2],
                               rtol=5e-4)
