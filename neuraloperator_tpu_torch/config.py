"""Dataclass configs with dotted-key CLI overrides (a copy of
``neuraloperator_tpu/config.py``, which the port may not import).

Nested dataclasses with ``to_dict()``, and ``make_config_from_cli``, which
applies ``--section.key value`` overrides (lists as ``[a,b]``). The grammar
and the defaults are the JAX package's, so one command line configures a
run of either package.
"""

import sys
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional


class ConfigBase:
    """Mixin for nested dataclass configs."""

    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to_dict() if isinstance(v, ConfigBase) else v
        return out

    def apply_overrides(self, overrides: Dict[str, str]):
        for key, raw in overrides.items():
            obj = self
            parts = key.split(".")
            for p in parts[:-1]:
                obj = getattr(obj, p)
            leaf = parts[-1]
            current = getattr(obj, leaf)
            setattr(obj, leaf, _coerce(raw, current))
        return self


def _coerce(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, (list, tuple)):
        items = [s for s in raw.strip("[]() ").split(",") if s]
        elem = current[0] if len(current) else 1
        return type(current)(_coerce(s.strip(), elem) for s in items)
    if current is None:
        for cast in (int, float):
            try:
                return cast(raw)
            except ValueError:
                pass
        if raw.lower() in ("none", "null"):
            return None
    return raw


def make_config_from_cli(config_cls, argv: Optional[List[str]] = None):
    """Instantiate ``config_cls`` and apply ``--a.b.c value`` CLI overrides."""
    if argv is None:
        argv = sys.argv[1:]
    cfg = config_cls()
    overrides = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok.startswith("--"):
            key = tok[2:]
            if "=" in key:
                key, val = key.split("=", 1)
                overrides[key] = val
                i += 1
            else:
                overrides[key] = argv[i + 1]
                i += 2
        else:
            i += 1
    cfg.apply_overrides(overrides)
    return cfg


# ---------------------------------------------------------------------- #
# The sections the training scripts use, with the JAX package's defaults
# ---------------------------------------------------------------------- #


@dataclass
class OptConfig(ConfigBase):
    n_epochs: int = 300
    learning_rate: float = 5e-3
    training_loss: str = "h1"
    weight_decay: float = 1e-4
    scheduler: str = "StepLR"
    step_size: int = 60
    gamma: float = 0.5
    # bf16 forward/backward with f32 master weights (Trainer mixed_precision)
    mixed_precision: bool = False
    # bf16 master params updated with unbiased stochastic rounding
    # (Trainer stochastic_rounding; pair with --model.weight_dtype bfloat16)
    stochastic_rounding: bool = False
    # > 0: track an EMA of the params in the optimizer state (with_ema);
    # training scripts report a second eval on the averaged params
    ema_decay: float = 0.0
    # AdamW state policy: "full" (f32 mu+nu, reference semantics),
    # "factored" (factored nu + bf16 mu), "factored8" (factored nu +
    # blockwise-int8 mu) — HBM-traffic levers, A/B'd in BASELINE.md
    opt_state: str = "full"


@dataclass
class FNOModelConfig(ConfigBase):
    model_arch: str = "fno"
    data_channels: int = 1
    out_channels: int = 1
    n_modes: List[int] = field(default_factory=lambda: [16, 16])
    hidden_channels: int = 24
    projection_channel_ratio: int = 2
    n_layers: int = 4
    domain_padding: Optional[float] = None
    norm: Optional[str] = None
    fno_skip: str = "linear"
    implementation: str = "factorized"
    factorization: Optional[str] = None
    rank: float = 1.0
    weight_dtype: str = "float32"
    # 'mixed': bf16 contraction operands, f32 accumulation (MXU-native)
    fno_block_precision: str = "full"
    scan_layers: bool = False


# model presets of the JAX package (reference config/models.py)


@dataclass
class FNO_Small2d(FNOModelConfig):
    """Darcy-scale FNO (reference config/models.py:46-56)."""

    n_modes: List[int] = field(default_factory=lambda: [16, 16])
    hidden_channels: int = 24
    projection_channel_ratio: int = 2


@dataclass
class FNO_Medium2d(FNOModelConfig):
    """NS-128^2-scale FNO (reference config/models.py:58-68)."""

    n_modes: List[int] = field(default_factory=lambda: [64, 64])
    hidden_channels: int = 64
    projection_channel_ratio: int = 4


@dataclass
class TFNO_Medium2d(FNO_Medium2d):
    """Tucker-factorized medium FNO (rank 0.1)."""

    model_arch: str = "tfno"
    factorization: str = "tucker"
    rank: float = 0.1
    implementation: str = "factorized"


@dataclass
class SFNO_Small2d(ConfigBase):
    """Spherical FNO on three fields (the JAX package's preset)."""

    model_arch: str = "sfno"
    data_channels: int = 3
    out_channels: int = 3
    n_modes: List[int] = field(default_factory=lambda: [16, 16])
    hidden_channels: int = 32
    n_layers: int = 4


@dataclass
class DistributedConfig(ConfigBase):
    use_distributed: bool = False
    model_parallel_size: int = 1
    seed: int = 666


@dataclass
class DarcyDataConfig(ConfigBase):
    batch_size: int = 8
    n_train: int = 1000
    train_resolution: int = 16
    n_tests: List[int] = field(default_factory=lambda: [100, 50])
    test_resolutions: List[int] = field(default_factory=lambda: [16, 32])
    test_batch_sizes: List[int] = field(default_factory=lambda: [16, 16])
    encode_input: bool = False
    encode_output: bool = True


@dataclass
class DarcyConfig(ConfigBase):
    """The Darcy recipe (``scripts/train_darcy.py``): FNO_Small2d's width
    (16x16 modes, hidden 24, 4 layers), 300 epochs of H1 at lr 5e-3 with
    StepLR(60, 0.5)."""

    model: FNOModelConfig = field(default_factory=FNOModelConfig)
    opt: OptConfig = field(default_factory=OptConfig)
    data: DarcyDataConfig = field(default_factory=DarcyDataConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    verbose: bool = True
    eval_interval: int = 1


__all__ = ["ConfigBase", "DarcyConfig", "DarcyDataConfig", "DistributedConfig",
           "FNOModelConfig", "FNO_Medium2d", "FNO_Small2d", "OptConfig", "SFNO_Small2d",
           "TFNO_Medium2d", "make_config_from_cli"]
