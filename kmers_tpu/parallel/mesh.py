"""Mesh construction helpers."""

from __future__ import annotations

import jax
from jax.sharding import Mesh

__all__ = ["data_mesh"]


def data_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices.

    K-mer workloads are embarrassingly data-parallel over sequence shards
    (SURVEY.md §2.7 item 1), so one "data" axis is all the algorithm
    needs; every card of the machine reaches every other at the same rate.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} available"
        )
    import numpy as np

    return Mesh(np.array(devices[:n_devices]), (axis,))
