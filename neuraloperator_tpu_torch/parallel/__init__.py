"""Distribution over ``torch.distributed`` (port of ``neuraloperator_tpu/parallel``).

``mesh``: the ('data', 'model') process groups, batch slicing and the
model-parallel split of the spectral contractions; ``comm``: accessors, the
model-parallel collectives with their backward, and tensor helpers;
``zero``: the optimizer state cut over the data ranks; ``distributed_fft``
and ``distributed_sht``: the spectral and spherical convolutions over a
height- or latitude-sharded domain with ``all_to_all``; ``distributed_gno``:
each model rank's slice of a point set; ``pipeline``: GPipe over the model
ranks; ``launch``: a group of spawned ranks with a hard deadline.
"""

from . import comm, mesh  # noqa: F401
from .distributed_fft import (  # noqa: F401
    DistributedSpectralConv2d,
    DistributedSpectralConv3d,
    distributed_spectral_conv2d,
    distributed_spectral_conv3d,
    halo_exchange,
)
from .distributed_gno import (  # noqa: F401
    point_sharding,
    shard_gino_inputs,
    shard_neighbors,
    shard_points,
)
from .distributed_sht import DistributedSphericalConv, distributed_spherical_conv  # noqa: F401
from .pipeline import gpipe, pipelined_fno_forward  # noqa: F401
from .zero import ZeroAdamW, bind_zero, shard_opt_state, zero_specs  # noqa: F401
