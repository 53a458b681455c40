"""Model loading for the port's entry points."""

from pope_tpu_torch.pipeline.api import PopeModels, load_models
