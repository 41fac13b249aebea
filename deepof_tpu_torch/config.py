"""Constants the public path reads (port of the parts of
``deepof_tpu/config.py`` it needs): distance units, the very-large-project
thresholds, the version string stored with a project, the default
supervised-annotation parameters and the behavior catalogue the supervised
rules name (deepof_tpu/config.py:49-92).
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


def default_supervised_parameters(frame_rate: float) -> dict:
    """Default supervised-annotation parameters: tolerances in mm, frame
    counts from the frame rate (deepof_tpu/config.py:179)."""
    return {
        "close_contact_tol": 25,
        "side_contact_tol": 50,
        "median_filter_width": int(frame_rate / 2),
        "follow_frames": int(frame_rate / 2),
        "min_follow_frames": int(frame_rate / 4),
        "follow_tol": 25,
        "climb_tol": 0.15,
        "sniff_arena_tol": 12.5,
        "min_immobility": int(frame_rate),
        "stationary_threshold": 40,
        "nose_likelihood": 0.85,
    }


# --------------------------------------------------------------------------- #
# Behavior catalogue (deepof_tpu/config.py:49-92)
# --------------------------------------------------------------------------- #

CUSTOM_BEHAVIOR_COLOR_MAP = {
    "custom_0": ("#0B3C5D", "#6A9AC8"),
    "custom_1": ("#004B23", "#4D9E6F"),
    "custom_2": ("#6A040F", "#C15F7A"),
    "custom_3": ("#3A0CA3", "#9B7ED9"),
    "custom_4": ("#7209B7", "#B78CE8"),
    "custom_5": ("#9A3412", "#E39E7A"),
    "custom_6": ("#7F4F24", "#C9A47F"),
    "custom_7": ("#8F7A00", "#D9C25C"),
    "custom_8": ("#006D77", "#4EB8C2"),
    "custom_9": ("#37474F", "#7A9EB3"),
}

SINGLE_BEHAVIORS = [
    "climb-arena", "sniff-arena", "immobility", "stat-lookaround",
    "stat-active", "stat-passive", "moving", "sniffing", "missing",
]
SYMMETRIC_BEHAVIORS = ["nose2nose", "sidebyside", "sidereside"]
ASYMMETRIC_BEHAVIORS = ["nose2tail", "nose2body", "following"]
CONTINUOUS_BEHAVIORS = ["distance", "cum-distance", "speed"]
