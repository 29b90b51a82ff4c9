"""Cityscapes class names and display palette (the 19 training classes)."""

from __future__ import annotations

import numpy as np

CLASS_NAMES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]

NUM_CLASSES = 19

# trainId -> display RGB for the 19 classes
TRAIN_ID_TO_COLOR = np.array([
    [128, 64, 128],   # road
    [244, 35, 232],   # sidewalk
    [70, 70, 70],     # building
    [102, 102, 156],  # wall
    [190, 153, 153],  # fence
    [153, 153, 153],  # pole
    [250, 170, 30],   # traffic light
    [220, 220, 0],    # traffic sign
    [107, 142, 35],   # vegetation
    [152, 251, 152],  # terrain
    [70, 130, 180],   # sky
    [220, 20, 60],    # person
    [255, 0, 0],      # rider
    [0, 0, 142],      # car
    [0, 0, 70],       # truck
    [0, 60, 100],     # bus
    [0, 80, 100],     # train
    [0, 0, 230],      # motorcycle
    [119, 11, 32],    # bicycle
], dtype=np.uint8)


def apply_color_map(segmentation_map: np.ndarray) -> np.ndarray:
    """trainId map (H, W) -> RGB image (H, W, 3); ids outside [0, 19)
    render black."""
    seg = np.asarray(segmentation_map)
    out = np.zeros((*seg.shape, 3), dtype=np.uint8)
    valid = (seg >= 0) & (seg < NUM_CLASSES)
    out[valid] = TRAIN_ID_TO_COLOR[seg[valid].astype(np.int64)]
    return out
