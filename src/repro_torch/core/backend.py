"""The engine's execution backend: the four data-plane entry points
(``probe_multi``, ``merge_kway``, ``merge_kway_window``, ``scan_merge``)
on the engine's device.

Dispatch follows the device and nothing else.  On a CUDA device every
entry point runs the hand-written kernels (the fused Bloom probe, the
merge-path merge inside the k-way tournament) or raises; on the CPU the
same code runs the kernels' plain PyTorch twins.  There is no per-op
mode, no calibration table and no fallback: unlike the reference's
``ExecBackend``, which chose host numpy or Pallas per size class and fell
back to numpy where compiled Pallas was missing, nothing here can run
the twin, or numpy, in place of a kernel on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.bloom.ops import bloom_probe_multi
from ..kernels.keys import keys_to_numpy, to_device
from ..kernels.merge.ops import merge_dedup_kway, merge_dedup_kway_window


class ExecBackend:
    """The data plane of one engine on one device.  Merge entry points
    return the compacted run both on the host (the authoritative
    mirrors) and on the device (adopted by the table it becomes)."""

    def __init__(self, device: "str | torch.device" = "cuda",
                 merge_block: int = 256):
        self.device = resolve_device(device)
        self.merge_block = int(merge_block)

    @staticmethod
    def _host(dk: torch.Tensor, dv: torch.Tensor):
        return keys_to_numpy(dk), dv.cpu().numpy()

    def probe_multi(self, filts: torch.Tensor, meta: np.ndarray,
                    keys: np.ndarray) -> np.ndarray:
        """Fused multi-table Bloom probe of host uint32 ``keys`` against
        the device filter stack: the (tables, keys) maybe-present matrix
        on the host."""
        return bloom_probe_multi(filts, meta, to_device(keys, self.device))

    def merge_kway(self, runs, drop_value: Optional[int] = None):
        """One-shot k-way newest-wins merge of device runs (newest
        first).  Returns ``(keys_np, vals_np, (keys, vals))``."""
        dk, dv = merge_dedup_kway(runs, block=self.merge_block,
                                  drop_value=drop_value)
        return (*self._host(dk, dv), (dk, dv))

    def merge_kway_window(self, runs, starts, stops,
                          drop_value: Optional[int] = None):
        """Streaming-quantum window merge: only the ``[starts[i],
        stops[i])`` slice of each device run (the engine cuts at a global
        key boundary, so windows compose bit-identically).  Returns
        ``(keys_np, vals_np, (keys, vals))`` like ``merge_kway``."""
        dk, dv = merge_dedup_kway_window(runs, starts, stops,
                                         block=self.merge_block,
                                         drop_value=drop_value)
        return (*self._host(dk, dv), (dk, dv))

    def scan_merge(self, runs, drop_value: Optional[int] = None):
        """The read plane's k-way merge of host run windows (range
        scans): uploads the windows, merges newest-wins with tombstones
        dropped in the merge, and returns host (keys, vals)."""
        dev_runs = [(to_device(k, self.device), to_device(v, self.device))
                    for k, v in runs]
        dk, dv = merge_dedup_kway(dev_runs, block=self.merge_block,
                                  drop_value=drop_value)
        return self._host(dk, dv)
