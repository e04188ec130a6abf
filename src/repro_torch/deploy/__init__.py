"""Deployment-plan subsystem: persistent schedule cache + shape bucketing +
batch planner, turning one-shot autotuning into a reusable serving pipeline.

    from repro_torch.deploy import Planner, PlanCache

    planner = Planner(hw, cache=PlanCache("results/plan_cache"))
    planner.batch_tune(model_workload(cfg, batch=8, seq=4096))   # cold, once
    plan = planner.plan(shape)                                   # warm: O(1)
"""
from repro_torch.deploy.batcher import (BATCH_MODES, Batch, BatchPolicy,
                                  ContinuousBatcher, Request, bucket_pool,
                                  decode_m)
from repro_torch.deploy.bucketing import (BucketingPolicy, adapt, bucket_of,
                                    distance, nearest_tuned, next_pow2,
                                    transfer_candidates)
from repro_torch.deploy.cache import CacheStats, PlanCache, plan_key
from repro_torch.deploy.plan import (DeploymentPlan, PLAN_SCHEMA_VERSION,
                               SOURCE_BUCKETED, SOURCE_TUNED, hw_fingerprint,
                               plan_from_tuning, schedule_from_dict,
                               schedule_to_dict, search_variant)
from repro_torch.deploy.planner import (Planner, arch_workload, model_workload,
                                  moe_dispatch_geometry, workload_coverage)

__all__ = [
    "BATCH_MODES", "Batch", "BatchPolicy", "BucketingPolicy", "CacheStats",
    "ContinuousBatcher", "DeploymentPlan", "PLAN_SCHEMA_VERSION",
    "PlanCache", "Planner", "Request", "SOURCE_BUCKETED", "SOURCE_TUNED",
    "adapt", "arch_workload", "bucket_of", "bucket_pool", "decode_m",
    "distance", "hw_fingerprint", "model_workload", "moe_dispatch_geometry",
    "nearest_tuned", "next_pow2", "plan_from_tuning", "plan_key",
    "schedule_from_dict", "schedule_to_dict", "search_variant",
    "transfer_candidates", "workload_coverage",
]
