"""A copy of ``repro.fleet.traces`` (numpy only; tests pin it bit-equal).

Seedable synthetic demand-trace generators.

The paper evaluates five STATIC scenarios; production allocators face
time-varying demand. Every generator returns a (T, m) float64 array of
per-tick resource demand (same resource convention as repro_torch.core.catalog:
cpu, mem_gb, net_units, storage_gb for the cloud catalogs), is deterministic
given ``seed``, and keeps demand strictly positive.

Ticks are hours unless noted — diurnal period 24, weekly period 168.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def _noise(rng: np.random.Generator, T: int, m: int, level: float) -> np.ndarray:
    """Multiplicative lognormal-ish noise around 1."""
    return np.exp(level * rng.standard_normal((T, m)))


def _positive(trace: np.ndarray, base: np.ndarray) -> np.ndarray:
    return np.maximum(trace, 0.05 * base[None, :])


def diurnal_trace(base: np.ndarray, T: int, *, amplitude: float = 0.4,
                  period: float = 24.0, phase: float = 0.0,
                  noise: float = 0.03, seed: int = 0) -> np.ndarray:
    """Day/night sinusoid: base * (1 + amplitude * sin(2 pi t / period))."""
    base = np.asarray(base, np.float64)
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float64)
    wave = 1.0 + amplitude * np.sin(2 * np.pi * (t + phase) / period)
    return _positive(base[None, :] * wave[:, None] * _noise(rng, T, len(base), noise),
                     base)


def flash_crowd_trace(base: np.ndarray, T: int, *, n_bursts: int = 2,
                      burst_scale: float = 3.0, decay: float = 6.0,
                      noise: float = 0.03, seed: int = 0) -> np.ndarray:
    """Baseline demand with sudden spikes decaying exponentially (viral
    events, incident failover). Burst times are drawn from ``seed``."""
    base = np.asarray(base, np.float64)
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float64)
    mult = np.ones(T)
    for start in sorted(rng.uniform(0.1 * T, 0.9 * T, size=n_bursts)):
        scale = burst_scale * rng.uniform(0.6, 1.4)
        after = t >= start
        mult = mult + after * (scale - 1.0) * np.exp(-(t - start) / decay)
    return _positive(base[None, :] * mult[:, None] * _noise(rng, T, len(base), noise),
                     base)


def ramp_trace(base: np.ndarray, T: int, *, end_scale: float = 4.0,
               start_frac: float = 0.2, end_frac: float = 0.8,
               noise: float = 0.03, seed: int = 0) -> np.ndarray:
    """Linear growth from base to end_scale*base between the two fractions
    of the horizon (product launch / steady adoption)."""
    base = np.asarray(base, np.float64)
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float64) / max(T - 1, 1)
    frac = np.clip((t - start_frac) / max(end_frac - start_frac, 1e-9), 0.0, 1.0)
    mult = 1.0 + (end_scale - 1.0) * frac
    return _positive(base[None, :] * mult[:, None] * _noise(rng, T, len(base), noise),
                     base)


def weekly_trace(base: np.ndarray, T: int, *, daily_amplitude: float = 0.35,
                 weekend_dip: float = 0.45, noise: float = 0.05,
                 seed: int = 0) -> np.ndarray:
    """Diurnal cycle modulated by a weekday/weekend square-ish wave —
    the classic enterprise traffic shape."""
    base = np.asarray(base, np.float64)
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=np.float64)
    daily = 1.0 + daily_amplitude * np.sin(2 * np.pi * t / 24.0)
    day_of_week = (t // 24.0) % 7
    weekday = np.where(day_of_week < 5, 1.0, 1.0 - weekend_dip)
    mult = daily * weekday
    return _positive(base[None, :] * mult[:, None] * _noise(rng, T, len(base), noise),
                     base)


def constant_trace(base: np.ndarray, T: int) -> np.ndarray:
    """Static demand — replaying it must reproduce the single-shot solve."""
    base = np.asarray(base, np.float64)
    return np.tile(base[None, :], (T, 1))


def spot_interruption_trace(base: np.ndarray, T: int, *, rate: float = 0.08,
                            mean_outage: float = 3.0,
                            seed: int = 0) -> np.ndarray:
    """Seeded spot AVAILABILITY overlay: (T, S) array in {0.0, 1.0}.

    The one registry kind that is not a demand trace: ``base``'s LENGTH
    sets the number of independent spot pools S (its values are unused) and
    each column is an on/off Markov chain — an available pool is
    interrupted with probability ``rate`` per tick and recovers with
    probability ``1/mean_outage`` (geometric outage lengths, mean
    ``mean_outage`` ticks). All pools start available. Consumers
    (``repro_torch.fleet.replay`` via ``TenantSpec.spot_availability``) zero an
    interrupted pool's capacity for the tick: mask/ub/lb of its catalog
    spot twins go to 0, so the controller must rebuy on-demand or eat the
    shortage — the repricing the ``spot_risk`` term anticipates."""
    base = np.asarray(base, np.float64)
    assert base.ndim == 1 and len(base) >= 1, base.shape
    assert 0.0 <= rate <= 1.0 and mean_outage >= 1.0, (rate, mean_outage)
    S = len(base)
    rng = np.random.default_rng(seed)
    recover = 1.0 / mean_outage
    avail = np.ones(S, np.float64)
    out = np.empty((T, S), np.float64)
    for t in range(T):
        out[t] = avail
        u = rng.random(S)
        # up pools fail w.p. rate; down pools recover w.p. 1/mean_outage
        avail = np.where(avail > 0.0,
                         (u >= rate).astype(np.float64),
                         (u < recover).astype(np.float64))
    return out


TRACE_KINDS: Dict[str, Callable] = {
    "diurnal": diurnal_trace,
    "flash_crowd": flash_crowd_trace,
    "ramp": ramp_trace,
    "weekly": weekly_trace,
    "constant": constant_trace,
    "spot_interruption": spot_interruption_trace,
}


def make_trace(kind: str, base: np.ndarray, T: int, *, seed: int = 0,
               **kwargs) -> np.ndarray:
    """Registry entry point: make_trace("diurnal", base, 72, seed=3)."""
    try:
        fn = TRACE_KINDS[kind]
    except KeyError:
        raise ValueError(f"unknown trace kind {kind!r}; "
                         f"choose from {sorted(TRACE_KINDS)}") from None
    if kind == "constant":
        # no seed (deterministic by construction); unknown kwargs raise
        # instead of being silently swallowed (a typo'd amplitude= would
        # otherwise produce a flat trace without complaint)
        return fn(base, T, **kwargs)
    return fn(base, T, seed=seed, **kwargs)
