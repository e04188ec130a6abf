"""Predicted-vs-measured drift monitor (jax-free).

PR 5's calibration loop trusts a `CalibrationProfile` once, at fit time
(`fit_ok`). This module turns that one-shot gate into a continuously
checked property: an online accumulator of (predicted seconds, measured
seconds) pairs per executed mode — the same measured-vs-predicted
methodology `sim/calibrate.py` uses offline — that reports per-mode drift
ratios, their geomean, and a `profile_stale` flag when the geomean drifts
past a threshold in EITHER direction (a profile predicting 2x too fast is
exactly as stale as one predicting 2x too slow, so staleness is judged on
`max(geomean, 1/geomean)`).

Feed it fresh measurements (`dryrun --calibrate` re-running
`measure_modes`) or the persisted samples written next to the profile
(`sim.calibrate.load_samples`) — either way the prediction side comes from
`CalibrationProfile.predict` on the sample's analytical `PerfReport`, so
the monitor checks the profile actually deployed, not the raw prior.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

# geomean(measured / predicted) distance from 1.0 beyond which the profile
# no longer describes the machine and should be re-fitted (dryrun
# --calibrate). 1.5 tolerates shared-host noise while catching a real
# hardware / runtime change; docs/observability.md documents the rationale.
DRIFT_STALE_THRESHOLD = 1.5


class DriftMonitor:
    """Online accumulator of measured/predicted log-ratios, per mode."""

    def __init__(self, profile=None,
                 threshold: float = DRIFT_STALE_THRESHOLD) -> None:
        if threshold < 1.0:
            raise ValueError(f"drift threshold must be >= 1.0 (a ratio "
                             f"distance), got {threshold}")
        self.profile = profile
        self.threshold = float(threshold)
        self._log_sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def add(self, mode: str, predicted_s: float, measured_s: float) -> None:
        """Record one executed-mode observation against its prediction."""
        if predicted_s <= 0.0 or measured_s <= 0.0:
            return
        self._log_sums[mode] = (self._log_sums.get(mode, 0.0)
                                + math.log(measured_s / predicted_s))
        self._counts[mode] = self._counts.get(mode, 0) + 1

    def add_samples(self, samples: Iterable) -> int:
        """Feed `CalibrationSample`s; predictions come from the monitor's
        profile (`profile.predict(sample.report)`) or, with no profile,
        from the raw analytical prior. Returns how many were added."""
        n = 0
        for s in samples:
            predicted = (self.profile.predict(s.report)
                         if self.profile is not None
                         else s.report.total_time)
            self.add(s.mode, predicted, s.measured_s)
            n += 1
        return n

    @property
    def n_samples(self) -> int:
        return sum(self._counts.values())

    def mode_ratio(self, mode: str) -> Optional[float]:
        """geomean(measured / predicted) for one mode, or None."""
        n = self._counts.get(mode, 0)
        if not n:
            return None
        return math.exp(self._log_sums[mode] / n)

    def summary(self) -> Dict[str, object]:
        """The run report's `drift` section."""
        per_mode = {
            mode: {"n": self._counts[mode],
                   "geomean_ratio": round(self.mode_ratio(mode), 4)}
            for mode in sorted(self._counts)
        }
        total = self.n_samples
        geomean = (math.exp(sum(self._log_sums.values()) / total)
                   if total else 1.0)
        distance = max(geomean, 1.0 / geomean) if geomean > 0 else math.inf
        return {
            "n_samples": total,
            "per_mode": per_mode,
            "geomean_ratio": round(geomean, 4),
            "drift_distance": round(distance, 4),
            "threshold": self.threshold,
            "profile_stale": bool(total and distance > self.threshold),
            "profile_digest": (self.profile.digest()
                               if self.profile is not None else ""),
            "profile_trusted": bool(getattr(self.profile, "fit_ok", False)),
        }
