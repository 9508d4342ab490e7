"""Contig consensus routing (port of alga_tpu/contig/consensus.py:74-96).

ALGA_DEVICE_CONSENSUS set: the votes and trim run on the device
(contig/device_consensus.py).  Otherwise the JAX package's host
`correct_all` runs; it reaches its own device version (and jax) only
under that variable, which this function has handled by then.
"""

from __future__ import annotations

import os

from alga_tpu_torch import _host
from alga_tpu_torch.contig.device_consensus import correct_all_device


def correct_all(contigs, batch, *, device=None) -> None:
    """Set every contig's seq by per-column majority vote and end trim."""
    if os.environ.get("ALGA_DEVICE_CONSENSUS"):
        correct_all_device(contigs, batch, device=device)
    else:
        _host.consensus.correct_all(contigs, batch)
