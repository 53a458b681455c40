"""Serving surfaces (port of pope_tpu/serve): the interactive segmentation
web demo and the continuous-batching pose service."""

from pope_tpu_torch.serve.pose_service import PoseService, make_pose_server
from pope_tpu_torch.serve.web_demo import WebDemo, make_demo_server, run_demo_server

__all__ = ["PoseService", "make_pose_server", "WebDemo", "make_demo_server", "run_demo_server"]
