"""Essential-matrix RANSAC and pose recovery (port of pope_tpu/solver/ransac.py)."""

from pope_tpu_torch.solver.ransac import RansacResult, draw_gumbel, estimate_pose_ransac
