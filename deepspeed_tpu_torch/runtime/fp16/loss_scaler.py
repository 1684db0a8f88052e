"""Loss scaling.

Port of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (analogue of the
reference ``LossScaler``/``DynamicLossScaler``). The scaler state is a small
tuple of Python scalars: the port's engine reads the overflow flag on the
host once per step, so scale adjustment and the skip happen there. bf16 and
fp32 training use the static scale 1.0.
"""

from typing import NamedTuple

INITIAL_LOSS_SCALE = "init_scale"
SCALE_WINDOW = "scale_window"
DELAYED_SHIFT = "delayed_shift"
CONSECUTIVE_HYSTERESIS = "consecutive_hysteresis"
MIN_LOSS_SCALE = "min_scale"


class LossScaleState(NamedTuple):
    cur_scale: float
    cur_hysteresis: int
    last_overflow_iter: int
    iteration: int

    def to_dict(self):
        """A plain dict of numbers (a checkpoint's ``loss_scale`` entry)."""
        return self._asdict()

    @classmethod
    def from_dict(cls, d):
        return cls(cur_scale=float(d["cur_scale"]), cur_hysteresis=int(d["cur_hysteresis"]),
                   last_overflow_iter=int(d["last_overflow_iter"]), iteration=int(d["iteration"]))


class LossScalerBase:
    """Static loss scaler (reference ``LossScaler``)."""

    dynamic = False

    def __init__(self, scale=1.0):
        self.loss_scale = float(scale)

    def init_state(self):
        return LossScaleState(cur_scale=self.loss_scale, cur_hysteresis=0, last_overflow_iter=-1,
                              iteration=0)

    def update(self, state, has_overflow):
        return state._replace(iteration=state.iteration + 1)

    def backward(self, loss):
        return loss * self.loss_scale


LossScaler = LossScalerBase


class DynamicLossScaler(LossScalerBase):
    """Dynamic scaler (reference ``DynamicLossScaler``): halve on overflow
    (with hysteresis), double after ``scale_window`` clean steps."""

    dynamic = True

    def __init__(self,
                 init_scale=2**32,
                 scale_factor=2.0,
                 scale_window=1000,
                 min_scale=1.0,
                 delayed_shift=1,
                 consecutive_hysteresis=False):
        super().__init__(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis

    def init_state(self):
        return LossScaleState(cur_scale=self.loss_scale, cur_hysteresis=self.delayed_shift,
                              last_overflow_iter=-1, iteration=0)

    def update(self, state, has_overflow):
        """Pure update from the step's overflow flag (a Python bool)."""
        it = state.iteration
        if has_overflow:
            if state.cur_hysteresis <= 1:
                scale = max(state.cur_scale / self.scale_factor, self.min_scale)
                hyst = state.cur_hysteresis
            else:
                scale, hyst = state.cur_scale, state.cur_hysteresis - 1
            return LossScaleState(scale, hyst, it, it + 1)
        # reference loss_scaler.py:195: consecutive_hysteresis re-arms every
        # clean step, otherwise each full clean window re-arms; with
        # last_overflow_iter=-1 the first doubling lands after exactly
        # scale_window clean updates
        window_full = (it - state.last_overflow_iter) % self.scale_window == 0
        scale = state.cur_scale * self.scale_factor if window_full else state.cur_scale
        hyst = self.delayed_shift if (self.consecutive_hysteresis or window_full) else state.cur_hysteresis
        return LossScaleState(scale, hyst, state.last_overflow_iter, it + 1)


def create_loss_scaler(fp16_config=None):
    """Build the scaler from the ``fp16`` config section (reference
    ``CreateLossScaler``)."""
    if fp16_config is None or not fp16_config.enabled:
        return LossScalerBase(1.0)
    if fp16_config.loss_scale and fp16_config.loss_scale > 0:
        return LossScalerBase(fp16_config.loss_scale)
    return DynamicLossScaler(
        init_scale=2**fp16_config.initial_scale_power,
        scale_window=fp16_config.loss_scale_window,
        min_scale=fp16_config.min_loss_scale,
        delayed_shift=fp16_config.hysteresis,
    )
