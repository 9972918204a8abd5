"""Frame selection: pick the training subset and write split lists.

Counterpart of fusionsense_tpu/priors/frame_select.py (numpy and JSON
only, the same code). Behavioral equivalent of the reference's frame
selection (reference utils/imgs_selection.py:11-75: copy the ids in train.txt to
selected_images/ and rewrite transforms.json with train/test/val splits).
Here the split is written into transforms.json in place (no file copying —
the dataparser reads splits, not directories). Also provides an automatic
max-coverage selector for when no train.txt exists: greedy farthest-point
selection on camera positions, which is what a ~9-view ring capture needs.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def farthest_point_camera_selection(origins: np.ndarray, k: int) -> list[int]:
    """Greedy max-min selection of k camera indices by position."""
    n = len(origins)
    if k >= n:
        return list(range(n))
    chosen = [0]
    d = np.linalg.norm(origins - origins[0], axis=-1)
    for _ in range(k - 1):
        nxt = int(np.argmax(d))
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(origins - origins[nxt], axis=-1))
    return sorted(chosen)


def write_splits(
    data_dir, train_names: list[str] | None = None, n_train: int | None = None,
    test_fraction: float = 0.0,
):
    """Rewrite transforms.json with train/test/val filename splits."""
    data_dir = Path(data_dir)
    path = data_dir / "transforms.json"
    with open(path) as f:
        meta = json.load(f)
    frames = meta["frames"]
    names = [fr["file_path"] for fr in frames]

    if train_names is None:
        assert n_train is not None, "need train_names or n_train"
        c2w = np.array([fr["transform_matrix"] for fr in frames])
        origins = c2w[:, :3, 3]
        idx = farthest_point_camera_selection(origins, n_train)
        train_names = [names[i] for i in idx]

    train_set = {Path(n).name for n in train_names}
    rest = [n for n in names if Path(n).name not in train_set]
    n_test = int(round(len(rest) * test_fraction)) if test_fraction else len(rest)
    meta["train_filenames"] = sorted(train_names)
    meta["test_filenames"] = sorted(rest[:n_test])
    meta["val_filenames"] = sorted(rest[n_test:])
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def read_train_txt(path) -> list[str]:
    """Parse the reference's train.txt id list (one image id per line)."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]
