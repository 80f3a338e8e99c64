"""A copy of ``repro.horizon.forecast`` (numpy only; tests pin it equal).

Demand forecasters for receding-horizon (MPC) allocation.

A forecaster is a tiny stateful object fed the OBSERVED demand stream one
tick at a time (:meth:`Forecaster.observe`) and asked for the next ``k``
ticks (:meth:`Forecaster.predict`) — the lookahead window the MPC controller
plans over. The contract:

* ``observe(d_t)`` is called exactly once per tick, in trace order, BEFORE
  any ``predict`` for that tick, with the raw ``(m,)`` demand vector.
* ``predict(k)`` returns a ``(k, m)`` float64 array forecasting ticks
  ``t+1 .. t+k`` (one-step-ahead first). It must not mutate state — calling
  it twice returns the same array.
* Forecasts are strictly positive (clamped at a small floor) so the
  demand-normalized problem construction stays well conditioned.
* Everything is deterministic given the observation stream: replaying the
  same trace through the same forecaster kind yields the same forecasts,
  which is what makes MPC replays reproducible (the same property the
  ``make_trace`` generators have for a given seed).

Kinds (registry :data:`FORECASTER_KINDS`, entry point
:func:`make_forecaster`, mirroring ``repro_torch.fleet.traces.make_trace``):

* ``last_value``   — persistence: tomorrow looks like today. The H=1
                     reference (MPC with it reproduces the myopic
                     controller; test-enforced).
* ``ewma``         — exponentially weighted moving average; flat forecast
                     at the smoothed level (noise-robust persistence).
* ``holt_winters`` — additive Holt-Winters with level/trend/seasonal
                     components; ``period`` matches the trace generators
                     (24 for diurnal, 168 for weekly).
* ``oracle``       — ground truth: reads the future straight from the
                     tenant's trace. Physically unrealizable; it is the
                     regret reference (docs/horizon.md) every real
                     forecaster is measured against.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

# forecasts are clamped elementwise at this floor: the solver normalizes
# K rows by 1/max(d, 1e-9), so a zero/negative forecast would blow up the
# conditioning of the time-expanded program
FORECAST_FLOOR = 1e-3


class Forecaster:
    """Base class defining the observe/predict contract (module docstring)."""

    def observe(self, demand: np.ndarray) -> None:
        """Feed one observed ``(m,)`` demand vector, in trace order."""
        raise NotImplementedError

    def predict(self, steps: int) -> np.ndarray:
        """Forecast the next ``steps`` ticks as a ``(steps, m)`` array."""
        raise NotImplementedError


def _clamp(pred: np.ndarray) -> np.ndarray:
    return np.maximum(np.asarray(pred, np.float64), FORECAST_FLOOR)


class LastValueForecaster(Forecaster):
    """Persistence forecast: every future tick equals the last observation."""

    def __init__(self) -> None:
        self._last: Optional[np.ndarray] = None

    def observe(self, demand: np.ndarray) -> None:
        """Record the latest demand vector."""
        self._last = np.asarray(demand, np.float64).copy()

    def predict(self, steps: int) -> np.ndarray:
        """(steps, m) copies of the last observation."""
        assert self._last is not None, "predict before any observe"
        return _clamp(np.tile(self._last, (steps, 1)))


class EWMAForecaster(Forecaster):
    """Exponentially weighted moving average; flat forecast at the level.

    ``alpha`` is the usual smoothing weight on the newest observation
    (alpha=1 degenerates to ``last_value``)."""

    def __init__(self, alpha: float = 0.3) -> None:
        assert 0.0 < alpha <= 1.0, alpha
        self.alpha = float(alpha)
        self._level: Optional[np.ndarray] = None

    def observe(self, demand: np.ndarray) -> None:
        """Fold the observation into the running level."""
        d = np.asarray(demand, np.float64)
        if self._level is None:
            self._level = d.copy()
        else:
            self._level = self.alpha * d + (1.0 - self.alpha) * self._level

    def predict(self, steps: int) -> np.ndarray:
        """(steps, m) copies of the smoothed level."""
        assert self._level is not None, "predict before any observe"
        return _clamp(np.tile(self._level, (steps, 1)))


class HoltWintersForecaster(Forecaster):
    """Additive Holt-Winters: level + trend + additive seasonal profile.

    ``period`` must match the trace's seasonality (24 ticks for the diurnal
    generators, 168 for weekly). Seasonal slots start at zero and are
    learned online, so the first period behaves like double-exponential
    smoothing and the seasonal shape sharpens from the second cycle on —
    no batch initialization pass is needed."""

    def __init__(self, period: int = 24, alpha: float = 0.35,
                 beta: float = 0.05, gamma: float = 0.25) -> None:
        assert period >= 1, period
        self.period = int(period)
        self.alpha, self.beta, self.gamma = float(alpha), float(beta), float(gamma)
        self._level: Optional[np.ndarray] = None
        self._trend: Optional[np.ndarray] = None
        self._season: Optional[np.ndarray] = None   # (period, m)
        self._t = 0                                 # observations so far

    def observe(self, demand: np.ndarray) -> None:
        """Standard additive Holt-Winters recurrences, one tick."""
        y = np.asarray(demand, np.float64)
        if self._level is None:
            self._level = y.copy()
            self._trend = np.zeros_like(y)
            self._season = np.zeros((self.period, len(y)), np.float64)
        else:
            slot = self._t % self.period
            s = self._season[slot]
            prev = self._level
            self._level = (self.alpha * (y - s)
                           + (1.0 - self.alpha) * (self._level + self._trend))
            self._trend = (self.beta * (self._level - prev)
                           + (1.0 - self.beta) * self._trend)
            self._season[slot] = (self.gamma * (y - self._level)
                                  + (1.0 - self.gamma) * s)
        self._t += 1

    def predict(self, steps: int) -> np.ndarray:
        """level + h*trend + the matching seasonal slot, h = 1..steps."""
        assert self._level is not None, "predict before any observe"
        h = np.arange(1, steps + 1, dtype=np.float64)
        # observation i lands in slot i % period; the h-step-ahead tick has
        # index (t-1) + h, hence slot (t - 1 + h) % period
        slots = (self._t - 1 + np.arange(1, steps + 1)) % self.period
        pred = (self._level[None, :] + h[:, None] * self._trend[None, :]
                + self._season[slots])
        return _clamp(pred)


class OracleForecaster(Forecaster):
    """Ground-truth forecast straight from the tenant's own trace.

    The regret reference: an MPC controller driven by the oracle pays only
    for the model's limits (horizon length, churn bound, convexification),
    never for forecast error. Past the end of the trace the last row is
    repeated (the controller never acts on those ticks anyway)."""

    def __init__(self, trace: np.ndarray) -> None:
        trace = np.asarray(trace, np.float64)
        assert trace.ndim == 2 and trace.shape[0] >= 1, trace.shape
        self.trace = trace
        self._t = 0                                 # observations so far

    def observe(self, demand: np.ndarray) -> None:
        """Advance the cursor (the trace itself already holds the value)."""
        self._t += 1

    def predict(self, steps: int) -> np.ndarray:
        """trace[t+1 .. t+steps], repeating the final row past the end."""
        assert self._t >= 1, "predict before any observe"
        idx = np.minimum(np.arange(self._t, self._t + steps),
                         self.trace.shape[0] - 1)
        return _clamp(self.trace[idx])


FORECASTER_KINDS: Dict[str, Callable] = {
    "last_value": LastValueForecaster,
    "ewma": EWMAForecaster,
    "holt_winters": HoltWintersForecaster,
    "oracle": OracleForecaster,
}


def make_forecaster(kind: str, *, trace: Optional[np.ndarray] = None,
                    **kwargs) -> Forecaster:
    """Registry entry point, mirroring ``make_trace``:
    ``make_forecaster("holt_winters", period=24)``.

    ``trace`` is consumed only by the ``"oracle"`` kind (which must read the
    future from somewhere); the real forecasters ignore it, so replay code
    can pass it unconditionally."""
    try:
        cls = FORECASTER_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown forecaster kind {kind!r}; "
                         f"choose from {sorted(FORECASTER_KINDS)}") from None
    if kind == "oracle":
        if trace is None:
            raise ValueError("oracle forecaster requires trace= (the ground-"
                             "truth demand it reads the future from)")
        return cls(trace, **kwargs)
    return cls(**kwargs)
