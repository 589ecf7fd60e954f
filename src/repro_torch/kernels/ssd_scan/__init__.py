"""Mamba-2 SSD chunked scan: the hand-written CUDA kernel and its plain
versions (the chunked dual form and the sequential recurrence)."""
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: F401
