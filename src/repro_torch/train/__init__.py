"""Training: AdamW and the train-step paths, the compressed data-parallel
SGD step (``compression``), the step-time watchdog and the resilient
control loops (``resilience``)."""

from .compression import (COMPRESSION_RATIO, build_dp_sgd_step,
                          compressed_psum, init_error_state)
from .resilience import (ElasticRunner, ResilienceConfig, ResilientStepLoop,
                         StepAbort)
from .watchdog import StepTimeWatchdog

__all__ = ["COMPRESSION_RATIO", "build_dp_sgd_step", "compressed_psum",
           "init_error_state", "StepTimeWatchdog", "ElasticRunner",
           "ResilienceConfig", "ResilientStepLoop", "StepAbort"]
