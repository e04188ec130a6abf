from repro_torch.sim.calibrate import (CalibrationProfile, CalibrationSample,
                                       fit_profile, is_trusted, load_profile,
                                       rank_stats, ranking_cost, save_profile)
from repro_torch.sim.perf import PerfReport, estimate

__all__ = ["CalibrationProfile", "CalibrationSample", "PerfReport",
           "estimate", "fit_profile", "is_trusted", "load_profile",
           "rank_stats", "ranking_cost", "save_profile"]
