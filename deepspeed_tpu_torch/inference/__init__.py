"""Inference engine of the port."""

from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  bucket_length,
                                                  sample_logits)

__all__ = ["InferenceEngine", "bucket_length", "sample_logits"]
