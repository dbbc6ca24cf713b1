"""Learning-rate schedules (port of ``chambers_tpu/schedules.py``): plain
``step -> lr`` callables that return Python floats, for the port's
optimizers (``chambers_tpu_torch.optimizers``).

``LinearWarmup`` wraps a scalar, a callable or a schedule: ``ramp=True``
ramps linearly from 0 to the inner schedule's step-0 rate over
``warmup_steps`` and then runs the inner schedule shifted by
``warmup_steps``; ``ramp=False`` multiplies the inner schedule by ``min(1,
step / warmup_steps)``. ``CosineDecay``, ``ExponentialDecay``,
``PiecewiseConstantDecay`` and ``PolynomialDecay`` have the math of
``tf.keras.optimizers.schedules``. The JAX package computes in float32 and
the port in float64: values agree to float32 rounding.
"""

import math


class LinearWarmup:
    def __init__(self, learning_rate, warmup_steps, ramp=True):
        self.learning_rate = learning_rate
        self.warmup_steps = float(warmup_steps)
        self.ramp = ramp
        if ramp:
            self.step_size = self._get_learning_rate(0) / warmup_steps

    def __call__(self, step):
        step = float(step)
        if self.ramp:
            if step < self.warmup_steps:
                return step * self.step_size
            return self._get_learning_rate(step - self.warmup_steps)
        lr_mult = min(1.0, step / self.warmup_steps)
        return self._get_learning_rate(step) * lr_mult

    def _get_learning_rate(self, step):
        if callable(self.learning_rate):
            try:
                return float(self.learning_rate(step))
            except TypeError:
                return float(self.learning_rate())
        return float(self.learning_rate)

    def get_config(self):
        return {"learning_rate": self.learning_rate,
                "warmup_steps": self.warmup_steps, "ramp": self.ramp}


class CosineDecay:
    """``lr = initial * ((1 - alpha) * 0.5 * (1 + cos(pi * min(step,
    decay_steps) / decay_steps)) + alpha)``."""

    def __init__(self, initial_learning_rate, decay_steps, alpha=0.0):
        self.initial_learning_rate = float(initial_learning_rate)
        self.decay_steps = float(decay_steps)
        self.alpha = float(alpha)

    def __call__(self, step):
        frac = min(float(step), self.decay_steps) / self.decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return self.initial_learning_rate * (
            (1.0 - self.alpha) * cosine + self.alpha)

    def get_config(self):
        return {"initial_learning_rate": self.initial_learning_rate,
                "decay_steps": self.decay_steps, "alpha": self.alpha}


class ExponentialDecay:
    """``lr = initial * decay_rate ** (step / decay_steps)``, the exponent
    floored when ``staircase``."""

    def __init__(self, initial_learning_rate, decay_steps, decay_rate,
                 staircase=False):
        self.initial_learning_rate = float(initial_learning_rate)
        self.decay_steps = float(decay_steps)
        self.decay_rate = float(decay_rate)
        self.staircase = bool(staircase)

    def __call__(self, step):
        exponent = float(step) / self.decay_steps
        if self.staircase:
            exponent = math.floor(exponent)
        return self.initial_learning_rate * self.decay_rate ** exponent

    def get_config(self):
        return {"initial_learning_rate": self.initial_learning_rate,
                "decay_steps": self.decay_steps,
                "decay_rate": self.decay_rate, "staircase": self.staircase}


class PiecewiseConstantDecay:
    """``values[i]`` for ``boundaries[i-1] < step <= boundaries[i]``."""

    def __init__(self, boundaries, values):
        if len(values) != len(boundaries) + 1:
            raise ValueError(
                "need len(values) == len(boundaries) + 1, got "
                f"{len(values)} values / {len(boundaries)} boundaries")
        self.boundaries = [float(b) for b in boundaries]
        self.values = [float(v) for v in values]

    def __call__(self, step):
        step = float(step)
        return self.values[sum(step > b for b in self.boundaries)]

    def get_config(self):
        return {"boundaries": self.boundaries, "values": self.values}


class PolynomialDecay:
    """A polynomial ramp from ``initial`` to ``end_learning_rate`` over
    ``decay_steps``; ``cycle=True`` restarts with a horizon that grows in
    multiples of ``decay_steps`` (the Keras ceil formulation)."""

    def __init__(self, initial_learning_rate, decay_steps,
                 end_learning_rate=1e-4, power=1.0, cycle=False):
        self.initial_learning_rate = float(initial_learning_rate)
        self.decay_steps = float(decay_steps)
        self.end_learning_rate = float(end_learning_rate)
        self.power = float(power)
        self.cycle = bool(cycle)

    def __call__(self, step):
        step = float(step)
        if self.cycle:
            multiplier = 1.0 if step == 0.0 else math.ceil(
                step / self.decay_steps)
            horizon = self.decay_steps * multiplier
        else:
            horizon = self.decay_steps
            step = min(step, horizon)
        frac = 1.0 - step / horizon
        return ((self.initial_learning_rate - self.end_learning_rate)
                * frac ** self.power + self.end_learning_rate)

    def get_config(self):
        return {"initial_learning_rate": self.initial_learning_rate,
                "decay_steps": self.decay_steps,
                "end_learning_rate": self.end_learning_rate,
                "power": self.power, "cycle": self.cycle}
