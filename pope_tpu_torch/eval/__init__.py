"""Manifest-driven evaluators mirroring the reference driver scripts
(eval_{linemod,onepose,onepose_plusplus,ycb}_json.py + acc1-30_*.py)."""

from pope_tpu_torch.eval.evaluate import evaluate_dataset, evaluate_pairs, results_to_xlsx
from pope_tpu_torch.eval.manifest import DATASETS, DatasetSpec, iter_pairs, load_manifest
