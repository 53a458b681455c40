"""Ops of the port: the CUDA attention kernels' wrappers and plain versions,
NMS, connected components, mask ops and resampling."""
