"""Essential-matrix RANSAC, pose recovery and closed-form alignment (port of
pope_tpu/solver)."""

from pope_tpu_torch.solver.ransac import N_HYPS, RansacResult, draw_gumbel, estimate_pose_ransac, recover_pose_from_E
from pope_tpu_torch.solver.umeyama import kabsch, umeyama_alignment
