"""Training: AdamW and the train-step paths, and the compressed
data-parallel SGD step (``compression``)."""

from .compression import (COMPRESSION_RATIO, build_dp_sgd_step,
                          compressed_psum, init_error_state)

__all__ = ["COMPRESSION_RATIO", "build_dp_sgd_step", "compressed_psum",
           "init_error_state"]
