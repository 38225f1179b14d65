"""Multi-host initialization hooks.

- ``initialize()`` wraps ``jax.distributed.initialize`` (pass the
  coordinator address, process count and process id explicitly; nothing
  discovers a cluster) and is a no-op on a single process;
- ``global_mesh()`` builds a mesh over *all* processes' devices; pass
  ``dcn_axis_sizes`` for the cross-process extent of each axis — that
  routes through ``mesh_utils.create_hybrid_device_mesh`` with the process
  as the granule, so the host-major layout keeps intra-host collectives on
  NVLink and only the named cross-process axes leave a host.

Everything else in :mod:`voicemap.parallel` is mesh-size and
process-count agnostic (shard_map over named axes), so multi-host enablement
is exactly these two calls at program start. The 2-process execution path is
exercised for real (localhost CPU, two processes × 4 faked devices, one DP
train step end-to-end) by tests/test_distributed_multiprocess.py.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed when running multi-process; returns whether
    distributed mode is active. Safe to call unconditionally."""
    num = num_processes if num_processes is not None else int(
        os.environ.get("VOICEMAP_NUM_PROCESSES", "1")
    )
    if num <= 1:
        return False
    if process_id is None:
        env_pid = os.environ.get("VOICEMAP_PROCESS_ID")
        # None lets jax auto-detect from the cluster environment; defaulting
        # to 0 would make every host claim process 0.
        process_id = int(env_pid) if env_pid is not None else None
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("VOICEMAP_COORDINATOR"),
        num_processes=num,
        process_id=process_id,
    )
    return True


def global_mesh(
    axis_sizes: Optional[Dict[str, int]] = None,
    dcn_axis_sizes: Optional[Dict[str, int]] = None,
) -> Mesh:
    """Mesh over every device of every process.

    Default: 1-D ``data`` axis across all global devices. Pass e.g.
    ``{"data": n_hosts*cards, "model": 1}`` for custom layouts.

    Multi-host: ``axis_sizes`` gives the per-process extent of each axis
    and ``dcn_axis_sizes`` the cross-process extent (axes absent there
    default to 1); the global mesh axis size is their product. E.g. two
    hosts of four cards doing pure DP: ``global_mesh({"data": 4},
    {"data": 2})``. Routed through ``mesh_utils.create_hybrid_device_mesh``
    with the process as the granule, so only the cross-process axes leave a
    host.
    """
    from jax.experimental import mesh_utils

    devices = jax.devices()
    if axis_sizes is None:
        axis_sizes = {"data": len(devices)}
    names = tuple(axis_sizes)
    sizes = tuple(axis_sizes.values())
    if dcn_axis_sizes is not None:
        unknown = set(dcn_axis_sizes) - set(names)
        if unknown:
            raise ValueError(f"dcn axes {unknown} not in mesh axes {names}")
        dcn_sizes = tuple(dcn_axis_sizes.get(n, 1) for n in names)
        if int(np.prod(sizes)) * int(np.prod(dcn_sizes)) != len(devices):
            raise ValueError(
                f"per-process mesh {axis_sizes} × cross-process mesh "
                f"{dcn_axis_sizes} does not "
                f"cover the {len(devices)} global devices"
            )
        dev = mesh_utils.create_hybrid_device_mesh(
            sizes, dcn_sizes, devices=devices, process_is_granule=True,
        )
        return Mesh(dev, names)
    if int(np.prod(sizes)) != len(devices):
        raise ValueError(
            f"mesh {axis_sizes} does not cover the {len(devices)} global devices"
        )
    dev = mesh_utils.create_device_mesh(sizes, devices=devices)
    return Mesh(dev, names)
