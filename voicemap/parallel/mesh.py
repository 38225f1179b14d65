"""Device-mesh helpers.

The reference has **no** distributed layer at all (SURVEY.md §2.3) — this
module is the rebuild's first-class replacement: ``jax.sharding.Mesh``
construction plus small utilities used by the DP train step, the sharded
distance matrix, and the halo-exchange conv. All programs written over these
meshes are mesh-size agnostic so they transfer from the faked CPU mesh used
in tests (SURVEY.md §4.5) to real multi-card meshes unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(axis_sizes: Dict[str, int], devices=None) -> Mesh:
    """Mesh from {'axis': size}; sizes must multiply to the device count used."""
    devices = devices if devices is not None else jax.devices()
    names = tuple(axis_sizes.keys())
    sizes = tuple(axis_sizes.values())
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"mesh needs {total} devices, have {len(devices)}")
    dev = np.asarray(devices[:total]).reshape(sizes)
    return Mesh(dev, names)


def data_mesh(num_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over all (or the first N) devices."""
    devices = jax.devices()
    n = num_devices or len(devices)
    return make_mesh({"data": n}, devices)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
