"""Input pipeline: threaded host-side prefetch and frame IO."""

from pope_tpu_torch.data.loader import ThreadedLoader
