"""Counting the host's waits for the card: a frozen copy.

Copied from `chip_smoke.py` at commit a3a4213 (`count_host_syncs`):
PyTorch's CUDA sync debug mode warns at every operation that makes the
host wait for the card (a read of a device value, a copy from pageable
memory, an explicit synchronize). A wait counts when the innermost frame
of the stack that lies in one of `roots` made it, so the benchmark's own
synchronizations are left out.
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import warnings

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep


@contextlib.contextmanager
def count_host_syncs(roots, sites: collections.Counter):
    """Within the block, counts into `sites` the host syncs made by code
    under the directories `roots`, by its `file:line`."""
    import torch

    roots = tuple(os.path.abspath(r) + os.sep for r in roots)

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        fr = sys._getframe(1)
        while fr is not None:
            name = fr.f_code.co_filename
            if name.startswith(roots):
                sites[f"{os.path.basename(name)}:{fr.f_lineno}"] += 1
                return
            if name.startswith(BENCH):
                return
            fr = fr.f_back

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode("default")
