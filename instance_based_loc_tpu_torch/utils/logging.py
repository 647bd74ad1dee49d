"""Conditional logging and memory statistics (counterpart of
`instance_based_loc_tpu/utils/logging.py`)."""

from __future__ import annotations

import torch


def conditional_log(statement, log_enabled: bool) -> None:
    if log_enabled:
        print(statement, flush=True)


def get_mem_stats(device=None) -> tuple[float, float]:
    """(host RSS GB, device peak GB): the peak is
    `torch.cuda.max_memory_allocated` of a CUDA `device`, and 0 on the
    CPU."""
    rss_gb = 0.0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    rss_gb = float(line.split()[1]) / 1e6
                    break
    except OSError:
        pass
    device_gb = 0.0
    if device is not None and torch.device(device).type == "cuda":
        device_gb = torch.cuda.max_memory_allocated(device) / 1e9
    return round(rss_gb, 3), round(device_gb, 3)
