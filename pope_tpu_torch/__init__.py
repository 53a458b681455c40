"""pope_tpu_torch — the PyTorch/CUDA port of pope_tpu for NVIDIA Hopper.

It mirrors pope_tpu's layout: ``models/{sam,dinov2,matcher}`` (SAM with its
automatic mask generator, the DINOv2 retrieval tower, the LoFTR matcher),
``ops`` (the hand-written CUDA attention kernels under ``csrc/`` with their
plain PyTorch versions, NMS, connected components, resampling), ``solver``
(RANSAC), ``pipeline`` (model loading, the retrieve -> match -> solve stage,
the eval runner), ``eval`` (the dataset driver, manifests, metric tables),
``data`` (the prefetch loader, frame IO), ``parallel`` (the launch ladder,
collectives, the (dp, tp) mesh, GPipe), ``cli.py`` (``eval``) and
``bench.py`` (the eval driver's benchmark line). Entry points run on CUDA
unless the caller passes ``device="cpu"``. It imports neither JAX nor
pope_tpu.
"""

__version__ = "0.1.0"
