"""pope_tpu_torch — the PyTorch/CUDA port of pope_tpu for NVIDIA Hopper.

It mirrors pope_tpu's layout: ``models/sam`` (encoder, prompt encoder, mask
decoder, automatic mask generation), ``ops`` (the hand-written CUDA attention
kernels under ``csrc/`` with their plain PyTorch versions, NMS, connected
components, resampling), ``pipeline/api.py`` (model loading). Entry points
run on CUDA unless the caller passes ``device="cpu"``. It imports neither JAX
nor pope_tpu.
"""

__version__ = "0.1.0"
