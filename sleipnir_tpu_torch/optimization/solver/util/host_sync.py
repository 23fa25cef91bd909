"""Counted device-to-host reads.

The solver's control flow (line search, regularization ladder, barrier
update) branches on values computed on the device. Each branch reads them
through one `HostSyncs.read`, which blocks until the device has caught up.
The count per iteration is the number of such stalls, the figure a later
change that captures the step as a CUDA graph has to drive to zero.
"""

from __future__ import annotations

import torch

from sleipnir_tpu_torch.util.profiler import span


class HostSyncs:
    """Reads device scalars for host-side branching and counts the reads."""

    def __init__(self) -> None:
        self.count = 0

    def read(self, *scalars: torch.Tensor):
        """One device-to-host transfer of one or more 0-d tensors.

        Returns a Python float/int/bool for one tensor, else a list of
        floats in argument order.
        """
        self.count += 1
        with span("slp.host_read"):
            if len(scalars) == 1:
                return scalars[0].item()
            return torch.stack([t.reshape(()).to(torch.float64) for t in scalars]).tolist()
