"""Arena calibration of a project (port of the parts of
``deepof_tpu/arena.py`` the public path reads: ``extract_corners_from_arena``,
the px -> mm scaling of arenas and ROIs, and the fixed arenas of test mode,
``arena.py:42-77,183-225,716-790``).

``scales[key] = [x_center_mm, y_center_mm, length_px, length_mm]``; arena
parameters and ROIs are stored in mm. Arena detection (SAM and OpenCV) and
the manual annotation windows are not ported: the machine with the card has
no cv2.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from deepof_tpu_torch.ops.geometry import ellipse_to_polygon

# Fixed synthetic user inputs substituted in test mode (arena.py:716-732).
_TEST_POLY_SCALES = {"test2": [279.5, 213.5, 420.12, 380], "test": [279.5, 213.5, 420.12, 380]}
_TEST_POLY_ARENAS = {
    "test2": np.array([(108, 30), (539, 29), (533, 438), (104, 431)]),
    "test": np.array([(108, 30), (323, 29), (539, 29), (533, 434), (323, 434), (104, 431)]),
}
_TEST_POLY_RES = {"test2": (480, 640), "test": (480, 640)}
_TEST_POLY_ROIS = {
    1: ((106, 230), (533, 230), (533, 438), (104, 431)),
    2: ((106, 230), (323, 230), (323, 438), (104, 431)),
}
_TEST_CIRC_SCALES = {"test2": [300.0, 38.0, 252.0, 380], "test": [300.0, 38.0, 252.0, 380]}
_TEST_CIRC_ELLIPSE = ((200, 195), (166, 169), 13.54)
_TEST_CIRC_RES = {"test2": (404, 416), "test": (404, 416)}
_TEST_CIRC_ROIS = {
    1: ((145, 130), (145, 255), (260, 255), (260, 130)),
    2: ((145, 190), (145, 255), (260, 255), (260, 190)),
}


def extract_corners_from_arena(arena_params: Tuple = None, num_points: int = 100) -> np.ndarray:
    """Polygon corners from arena parameters: polygonal arrays pass
    through; a ((cx, cy), (ax, ay), angle_deg) ellipse tuple is rasterised
    into ``num_points`` vertices."""
    p = arena_params
    is_ellipse = (
        isinstance(p, tuple) and len(p) == 3
        and np.ndim(p[0]) == 1 and len(p[0]) == 2
        and np.ndim(p[1]) == 1 and len(p[1]) == 2
        and np.ndim(p[2]) == 0
    )
    if not is_ellipse:
        return np.asarray(p, float)
    return ellipse_to_polygon(*p, n_points=num_points)


def scale_arenas_to_mm(arena_params: Dict, scales: Dict) -> Dict:
    out = {}
    for key, params in arena_params.items():
        ratio = scales[key][3] / scales[key][2]
        if isinstance(params, (np.ndarray, list)):
            out[key] = np.array(params) * ratio
        elif isinstance(params, tuple):
            out[key] = (
                tuple(np.array(params[0]) * ratio),
                tuple(np.array(params[1]) * ratio),
                params[2],
            )
        else:
            raise ValueError("Could not scale arena to mm!")
    return out


def scale_rois_to_mm(roi_dicts: Dict, scales: Dict) -> Dict:
    return {
        key: {k: np.array(roi) * (scales[key][3] / scales[key][2]) for k, roi in rois.items()}
        for key, rois in roi_dicts.items()
    }


def fixture_arenas(arena: str):
    """(scales, arena_params_mm, roi_dicts_mm, video_resolution) of test
    mode: the fixed arenas of the recordings "test" and "test2", polygonal
    when ``arena`` names a polygonal arena, else circular."""
    if "polygonal" in arena:
        scales = dict(_TEST_POLY_SCALES)
        arena_params = {k: v.copy() for k, v in _TEST_POLY_ARENAS.items()}
        video_resolution = dict(_TEST_POLY_RES)
        roi_dicts = {"test": dict(_TEST_POLY_ROIS), "test2": dict(_TEST_POLY_ROIS)}
    else:
        scales = dict(_TEST_CIRC_SCALES)
        arena_params = {
            "test2": extract_corners_from_arena(_TEST_CIRC_ELLIPSE),
            "test": _TEST_CIRC_ELLIPSE,
        }
        video_resolution = dict(_TEST_CIRC_RES)
        roi_dicts = {"test": dict(_TEST_CIRC_ROIS), "test2": dict(_TEST_CIRC_ROIS)}
    return (
        scales, scale_arenas_to_mm(arena_params, scales),
        scale_rois_to_mm(roi_dicts, scales), video_resolution,
    )
