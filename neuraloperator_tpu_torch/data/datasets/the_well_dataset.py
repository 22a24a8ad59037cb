"""Wrappers of the ``the_well`` PDE dataset collection (port of
``neuraloperator_tpu/data/datasets/the_well_dataset.py``): ``WellDataset``,
``ActiveMatterDataset`` and ``MHD64Dataset``.

``the_well`` is an optional package: without it the classes raise an
``ImportError`` that names it when they are made. Each item is the_well's
dict with every array-like value as a numpy array (channels last:
``input_fields`` (n_steps_input, d1..dN, c), ``output_fields``,
``constant_fields``), which ``data.transforms.TheWellDataProcessor`` lays
out for a model.
"""

import numpy as np


def _require_the_well():
    try:
        import the_well

        return the_well
    except ImportError as e:
        raise ImportError(
            "This dataset requires the optional 'the_well' package "
            "(https://github.com/PolymathicAI/the_well), which is not "
            "installed in this environment."
        ) from e


class WellDataset:
    """One dataset of the_well, read through its ``the_well.data.WellDataset``."""

    def __init__(self, well_base_path, well_dataset_name, well_split_name,
                 n_steps_input=1, n_steps_output=1, **kwargs):
        _require_the_well()
        from the_well.data import WellDataset as _WellDataset

        self._ds = _WellDataset(
            well_base_path=str(well_base_path),
            well_dataset_name=well_dataset_name,
            well_split_name=well_split_name,
            n_steps_input=n_steps_input,
            n_steps_output=n_steps_output,
            **kwargs,
        )

    def __len__(self):
        return len(self._ds)

    def __getitem__(self, idx):
        item = self._ds[idx]
        return {k: (np.asarray(v) if hasattr(v, "__array__") else v) for k, v in item.items()}


class ActiveMatterDataset(WellDataset):
    """the_well's ``active_matter``."""

    def __init__(self, well_base_path, well_split_name="train", **kwargs):
        super().__init__(well_base_path=well_base_path, well_dataset_name="active_matter",
                         well_split_name=well_split_name, **kwargs)


class MHD64Dataset(WellDataset):
    """the_well's ``MHD_64``."""

    def __init__(self, well_base_path, well_split_name="train", **kwargs):
        super().__init__(well_base_path=well_base_path, well_dataset_name="MHD_64",
                         well_split_name=well_split_name, **kwargs)


__all__ = ["ActiveMatterDataset", "MHD64Dataset", "WellDataset"]
