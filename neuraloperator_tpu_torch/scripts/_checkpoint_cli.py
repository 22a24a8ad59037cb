"""What the Navier–Stokes evaluation scripts share: ``--device`` beside the
JAX scripts' config flags, the checkpoint's normalizers, and the FNO their
configs describe with the checkpoint's weights in it."""

import argparse

from .._common import resolve_device
from ..data.datasets import load_navier_stokes_pt
from ..data.transforms import load_data_processor
from ..models import FNO
from ..training.training_state import load_training_state


def split_device(argv):
    """``(device, the config's arguments)``: ``--device`` is the port's own."""
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--device", default="cuda")
    args, rest = p.parse_known_args(argv)
    return args.device, rest


def checkpoint_processor(save_dir, res: int, device):
    """The normalizers saved with the checkpoint (``data_processor.json``);
    for a checkpoint without them, refit channel-wise (resolution-free) on
    256 training pairs at ``res``, as the JAX scripts fall back."""
    dp = load_data_processor(save_dir)
    if dp is not None:
        print(f"using saved normalizers from {save_dir}")
        return dp
    _, _, dp = load_navier_stokes_pt(
        n_train=256, n_tests=[8], batch_size=8, test_batch_sizes=[8],
        train_resolution=res, test_resolutions=[res], device=device,
    )
    return dp


def load_fno(config, device):
    """The FNO of ``config``'s ``n_modes``, ``hidden_channels`` and
    ``projection_channel_ratio`` (JAX defaults otherwise), in eval mode on
    ``device``, holding ``{save_name}.msgpack`` of ``save_dir``."""
    device = resolve_device(device)
    model = FNO(
        n_modes=(config.n_modes, config.n_modes), in_channels=1, out_channels=1,
        hidden_channels=config.hidden_channels,
        projection_channel_ratio=config.projection_channel_ratio, device="meta",
    )
    state, _, epoch = load_training_state(config.save_dir, config.save_name,
                                          model.state_dict(), device=device)
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    print(f"loaded {config.save_name} (epoch {epoch})")
    return model.eval()
