"""Post-hoc kinematics tables (port of the part of ``deepof_tpu/posthoc.py``
that the supervised engine reads: ``_kinematics_table_views`` :76, as
``annotate.supervised_annotation`` calls it). The rest of post-hoc is
ROADMAP queue 1 item 12.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from deepof_tpu_torch.core.storage import DeviceTable
from deepof_tpu_torch.utils import filter_columns


def _kinematics_table_views(
    coordinates, views: Sequence[Optional[str]], key: str, center: str = "Center", align: str = "Spine_1",
    distance_pairs=None,
) -> Dict[Optional[str], DeviceTable]:
    """One recording's kinematics table for each animal view (None = every
    animal), from one set of device tables: the bodypart distances (only
    ``distance_pairs`` when given, else every pair) and the body areas with
    the suffix ``_raw``, then the speeds of the coordinates centred on
    ``center`` and aligned on ``align`` with ``_speed``. A view keeps its
    animal's columns (areas by prefix). This is the JAX function at
    ``kin_derivative=1`` with no angles and no feature derivatives."""
    parts = (
        (*coordinates.get_distances_at_key(key, filter_on_graph=False, pairs=distance_pairs, _device=True),
         "_raw", False),
        (*coordinates.get_areas_at_key(key, _device=True), "_raw", True),
        (*coordinates.get_coords_at_key(key, center=center, align=align, speed=1, _device=True), "_speed", False),
    )
    out = {}
    for view in views:
        values, names = [], []
        for arr, cols, suffix, is_areas in parts:
            if view is None:
                keep = list(range(len(cols)))
            elif is_areas:
                keep = [i for i, c in enumerate(cols) if c.startswith(view)]
            else:
                kept = set(filter_columns(cols, view))
                keep = [i for i, c in enumerate(cols) if c in kept]
            values.append(arr[:, keep])
            names += [f"{cols[i]}{suffix}" for i in keep]
        out[view] = DeviceTable(torch.cat(values, dim=1), names)
    return out
