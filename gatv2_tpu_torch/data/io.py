"""Dataset IO: the reference's four-file whitespace text CSR format (port
of gatv2_tpu/data/io.py, numpy parser only).

  features.txt — one line per node, F floats separated by spaces
  row_ptr.txt  — N+1 ints (CSR row pointer over destination nodes)
  col_idx.txt  — E ints (source/neighbor indices)
  labels.txt   — N ints (one class label per node)

The dataset lives in `<root>/<name>/`, with root taken from `--data-root`,
else env `DATA_ROOT`, else `./data`.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from gatv2_tpu_torch.data.graph import Graph


def resolve_dataset_dir(
    dataset: str, data_root: str | None = None
) -> pathlib.Path:
    """Resolve `<root>/<dataset>/` with the reference's precedence rules."""
    if data_root is None:
        data_root = os.environ.get("DATA_ROOT", "./data")
    return pathlib.Path(data_root) / dataset


def load_features(path: pathlib.Path) -> np.ndarray:
    """Dense [N, F] float32; N and F inferred from the file; ragged rows
    are an error."""
    with open(path) as f:
        first = f.readline()
    ncols = len(first.split())
    if ncols == 0:
        raise ValueError(f"{path}: empty first row")
    flat = np.fromfile(path, dtype=np.float32, sep=" ")
    if flat.size % ncols != 0:
        raise ValueError(
            f"{path}: total value count {flat.size} is not a multiple of the "
            f"first row's width {ncols} (ragged rows?)"
        )
    return flat.reshape(-1, ncols)


def load_int_array(path: pathlib.Path) -> np.ndarray:
    """Whitespace-separated ints."""
    return np.fromfile(path, dtype=np.int64, sep=" ").astype(np.int32)


def load_dataset(dataset: str, data_root: str | None = None) -> Graph:
    d = resolve_dataset_dir(dataset, data_root)
    if not d.is_dir():
        raise FileNotFoundError(
            f"Dataset directory not found: {d} (dataset={dataset!r}). "
            f"Expected features.txt/row_ptr.txt/col_idx.txt/labels.txt inside."
        )
    for fname in ("features.txt", "row_ptr.txt", "col_idx.txt", "labels.txt"):
        if not (d / fname).is_file():
            raise FileNotFoundError(f"Missing {fname} in {d}")
    return Graph(
        features=load_features(d / "features.txt"),
        row_ptr=load_int_array(d / "row_ptr.txt"),
        col_idx=load_int_array(d / "col_idx.txt"),
        labels=load_int_array(d / "labels.txt"),
    )
