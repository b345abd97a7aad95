"""Pipeline parallelism: only the analytic cost model
(:mod:`repro_torch.pipeline.costs`) so far, which the planner's hybrid
sweep and the memory model use; the partitioner, ``PipelineSpec`` and the
GPipe / 1F1B schedules wait for ROADMAP queue 1, item 10."""
