"""Inference stack (reference ``deepspeed/inference/``)."""

from deepspeed_tpu_torch.inference.auto import from_pretrained, load_pretrained
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine

__all__ = ["DeepSpeedInferenceConfig", "InferenceEngine", "from_pretrained",
           "load_pretrained"]
