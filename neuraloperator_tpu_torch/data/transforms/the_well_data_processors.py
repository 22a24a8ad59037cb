"""Data processor for the_well-style autoregressive rollout datasets (port of
``neuraloperator_tpu/data/transforms/the_well_data_processors.py``).

Batches come in the_well's layout, channels last:

- ``input_fields``  ``(b, n_steps_input, d1..dN, c)``
- ``output_fields`` ``(b, T, d1..dN, c)``
- ``constant_fields`` ``(b, d1..dN, c_const)``, optional

The processor moves the channels first, normalizes the time-varying fields
channel-wise (``data_normalizer``) and the constant fields with their own
``const_normalizer``, flattens time into channels when
``time_as_channels`` (t-major: channel block ``t * c + j`` is step ``t``'s
channel ``j``) and appends the normalized constants to ``x``.

The ``Trainer``'s autoregressive evaluation (``evaluate(mode=
"autoregression")``) takes a trajectory batch through
:meth:`format_rollout_batch` (the first model input, and the raw rest of the
trajectory as ``(b, T, c, spatial...)`` targets) and feeds each prediction
back through :meth:`ar_feedback`, a function of the previous input and the
new prediction: the input window moves one step, the normalized prediction
is appended and the constant channels are kept. It reads nothing from the
device, so a rollout never waits on the host between steps.

Samples already formatted as ``{'x', 'y'}`` keep the older behaviour: ``x``
normalized, ``y`` normalized when training, predictions unnormalized when
evaluating.

Arrays may be numpy arrays or tensors; the results are tensors.
"""

from typing import Optional

import numpy as np
import torch

from .data_processors import DataProcessor

_FIELD_KEYS = ("input_fields", "output_fields", "constant_fields")


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


class TheWellDataProcessor(DataProcessor):
    """Normalization, the_well's layout and autoregressive stepping.

    ``data_normalizer``: channel-wise statistics fitted on
    ``(b, c, t, d1..dN)`` (``dim=[0, 2, 3, ...]``); ``const_normalizer``:
    statistics on ``(b, c_const, d1..dN)``; ``time_as_channels`` needs
    ``n_steps_output == 1``; ``n_steps_rollout`` caps the ``Trainer``'s
    autoregressive horizon; ``normalizer`` is the older name of
    ``data_normalizer``.
    """

    def __init__(
        self,
        data_normalizer=None,
        const_normalizer=None,
        n_steps_input: int = 1,
        n_steps_output: int = 1,
        time_as_channels: bool = True,
        n_steps_rollout: Optional[int] = None,
        normalizer=None,
    ):
        if normalizer is not None and data_normalizer is None:
            data_normalizer = normalizer
        self.data_normalizer = data_normalizer
        self.normalizer = data_normalizer
        self.const_normalizer = const_normalizer
        self.n_steps_input = n_steps_input
        self.n_steps_output = n_steps_output
        self.time_as_channels = time_as_channels
        self.n_steps_rollout = n_steps_rollout
        if time_as_channels and n_steps_output != 1:
            raise ValueError("time_as_channels requires n_steps_output == 1: predict several "
                             "output steps with a spatiotemporal model instead")
        self._schema_used = False
        self._n_var_channels = None  # the channels of x that hold the variables
        self._step_channels = None  # the channels of one step
        self._last_prediction = None  # the {'x', 'y'} path's feedback

    # statistics fitted on (b, c, t, spatial...) applied to a time-flattened
    # (b, c, spatial...) array through a time axis of one
    def _stats_ndim(self) -> Optional[int]:
        mean = getattr(self.data_normalizer, "mean", None)
        return None if mean is None else np.ndim(mean)

    def _norm(self, a: torch.Tensor) -> torch.Tensor:
        if self._stats_ndim() == a.ndim + 1:
            return self.data_normalizer.transform(a.unsqueeze(2)).squeeze(2)
        return self.data_normalizer.transform(a)

    def _unnorm(self, a: torch.Tensor) -> torch.Tensor:
        if self._stats_ndim() == a.ndim + 1:
            return self.data_normalizer.inverse_transform(a.unsqueeze(2)).squeeze(2)
        return self.data_normalizer.inverse_transform(a)

    @staticmethod
    def _flatten_time(a: torch.Tensor) -> torch.Tensor:
        """(b, c, t, spatial...) -> (b, t * c, spatial...), t-major."""
        b, c, t = a.shape[:3]
        return a.transpose(1, 2).reshape(b, t * c, *a.shape[3:])

    def _format_x(self, fields, constants) -> torch.Tensor:
        """The model input from the_well's fields; records the channel split
        that :meth:`ar_feedback` reads."""
        x = torch.movedim(_tensor(fields), -1, 1)  # (b, c, t, spatial...)
        self._step_channels = int(x.shape[1])
        n_t = int(x.shape[2])
        if self.data_normalizer is not None:
            x = self.data_normalizer.transform(x)
        if self.time_as_channels:
            x = self._flatten_time(x)
            self._n_var_channels = self._step_channels * n_t
        else:
            self._n_var_channels = self._step_channels
        if constants is not None:
            cf = torch.movedim(_tensor(constants), -1, 1)  # (b, cc, spatial...)
            if self.const_normalizer is not None:
                cf = self.const_normalizer.transform(cf)
            if not self.time_as_channels:  # x keeps its time axis: repeat along it
                cf = cf.unsqueeze(2).expand(*cf.shape[:2], n_t, *cf.shape[2:])
            x = torch.cat([x, cf.to(x.dtype)], dim=1)
        return x

    def preprocess(self, sample: dict, train: bool = True, step: int = 0) -> dict:
        sample = dict(sample)
        if "output_fields" in sample or "input_fields" in sample:
            self._schema_used = True
            fields = sample.get("input_fields")
            if fields is None:
                # the first n_steps_input steps of the trajectory are the input
                fields = _tensor(sample["output_fields"])[:, :self.n_steps_input]
            x = self._format_x(fields, sample.get("constant_fields"))
            y = torch.movedim(_tensor(sample["output_fields"]), -1, 1)
            if "input_fields" not in sample:
                # a trajectory: the target window starts after the input steps
                y = y[:, :, self.n_steps_input:][:, :, :self.n_steps_output]
            if self.data_normalizer is not None:
                y = self.data_normalizer.transform(y)
            if self.time_as_channels:
                y = self._flatten_time(y)
            out = {k: v for k, v in sample.items() if k not in _FIELD_KEYS}
            out["x"], out["y"] = x, y
            return out

        if step > 0 and self._last_prediction is not None:
            sample["x"] = self._last_prediction
        if self.normalizer is not None and not self._schema_used:
            sample["x"] = self.normalizer.transform(sample["x"])
            if train and sample.get("y") is not None:
                sample["y"] = self.normalizer.transform(sample["y"])
        return sample

    def postprocess(self, out, sample: dict, train: bool = True):
        if self.data_normalizer is not None and not train:
            out = self._unnorm(out) if self._schema_used else \
                self.data_normalizer.inverse_transform(out)
            if self._schema_used and sample.get("y") is not None:
                # evaluation compares unnormalized fields
                sample = dict(sample)
                sample["y"] = self._unnorm(sample["y"])
        self._last_prediction = out
        return out, sample

    # the rollout protocol of Trainer._eval_autoregressive
    def format_rollout_batch(self, sample: dict) -> dict:
        """A trajectory batch in the_well's layout -> ``{'x': first input,
        'y': targets}``: ``x`` formatted from the first ``n_steps_input``
        steps (normalized, constants appended), ``y`` the raw rest of the
        trajectory as ``(b, T, c, spatial...)``."""
        self._schema_used = True
        of = _tensor(sample["output_fields"])  # (b, T, spatial..., c)
        fields = sample.get("input_fields")
        if fields is None:
            fields = of[:, :self.n_steps_input]
        x = self._format_x(fields, sample.get("constant_fields"))
        y = torch.movedim(of, -1, 2)  # (b, T, c, spatial...)
        if "input_fields" not in sample:
            y = y[:, self.n_steps_input:]
        out = {k: v for k, v in sample.items() if k not in _FIELD_KEYS}
        out["x"], out["y"] = x, y
        return out

    def ar_feedback(self, x_prev: torch.Tensor, prediction: torch.Tensor) -> torch.Tensor:
        """The next model input: the oldest input step dropped, the
        normalized prediction appended, the constant channels kept."""
        if self._n_var_channels is None:
            return prediction
        c = self._step_channels
        pred = self._norm(prediction) if self.data_normalizer is not None else prediction
        var = x_prev[:, :self._n_var_channels]
        const = x_prev[:, self._n_var_channels:]
        if self.time_as_channels:
            # t-major: the first c channels are the oldest step
            var = torch.cat([var[:, c:], pred.to(var.dtype)], dim=1)
        else:
            var = torch.cat([var[:, :, 1:], pred.unsqueeze(2).to(var.dtype)], dim=2)
        if const.shape[1]:
            return torch.cat([var, const], dim=1)
        return var


__all__ = ["TheWellDataProcessor"]
