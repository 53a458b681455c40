"""Model loading and the retrieve -> match -> solve stage of the port."""

from pope_tpu_torch.pipeline.api import PopeModels, load_models
from pope_tpu_torch.pipeline.pose_pipeline import PairResult, PipelineExecutor
