"""Write the JAX script's initial FNOGNO weights to a flax msgpack file.

``scripts/train_fnogno_carcfd.py --data_source synthetic`` draws its FNOGNO
from ``PRNGKey(0)`` on the first synthetic sample's shapes. This tool makes
the same draw and writes it with ``flax.serialization``, so that
``tools/fnogno_init_spread.py`` can start the PyTorch port's script from the
JAX script's weights. It runs on the CPU, with the JAX package:

  PYTHONPATH= JAX_PLATFORMS=cpu python tools/jax_fnogno_init.py OUT.msgpack
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from neuraloperator_tpu.data.datasets import load_synthetic_cfd  # noqa: E402
from neuraloperator_tpu.models import FNOGNO as JFNOGNO  # noqa: E402
from neuraloperator_tpu_torch import convert  # noqa: E402
from neuraloperator_tpu_torch.scripts import train_fnogno_carcfd as port  # noqa: E402


def main(out: str) -> None:
    config = port.CarConfig(data_source="synthetic")
    model = JFNOGNO(in_channels=1, out_channels=1, gno_coord_dim=3, gno_radius=config.radius,
                    fno_n_modes=(8, 8, 8), fno_hidden_channels=32, fno_n_layers=4,
                    gno_max_neighbors=config.max_neighbors, gno_batched=False)
    # the generator is sequential: its first sample is the script's first
    in_p, out_p, f, _ = (jnp.asarray(t.numpy())
                         for t in port.prep(load_synthetic_cfd(1)[0], "cpu"))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), in_p, out_p, f)["params"]
    convert.check_flax_params(params, port.build_model(config, device="cpu").state_dict())
    Path(out).write_bytes(serialization.msgpack_serialize(jax.device_get(params)))
    print(f"wrote {out}")


if __name__ == "__main__":
    main(sys.argv[1])
