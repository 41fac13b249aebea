"""Constants the public path reads (port of the parts of
``deepof_tpu/config.py`` it needs): distance units, the very-large-project
thresholds and the version string stored with a project.
"""

from __future__ import annotations

from enum import Enum

CURRENT_VERSION = "0.1.0"


class DistanceUnit(Enum):
    """Conversion factors to internal mm storage. pixel maps to 0 (no scale)."""

    pixel = 0.0
    px = 0.0
    mm = 1.0
    millimeter = 1.0
    cm = 10
    centimeter = 10
    m = 1000
    meter = 1000
    km = 1000000
    kilometer = 1000000
    inch = 25.4


# Out-of-core switch: frames in one video / total frames across videos.
VERY_LARGE_VIDEO_FRAMES = 360_000
VERY_LARGE_TOTAL_FRAMES = 900_000
