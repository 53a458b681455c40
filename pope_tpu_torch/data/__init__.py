"""Input pipeline: threaded host-side prefetch, device prefetch, frame IO,
and the matcher-training scene datasets."""

from pope_tpu_torch.data.loader import DevicePrefetcher, ThreadedLoader
