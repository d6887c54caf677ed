"""Dataset IO: the reference's four-file whitespace text CSR format (port
of gatv2_tpu/data/io.py).

  features.txt — one line per node, F floats separated by spaces
  row_ptr.txt  — N+1 ints (CSR row pointer over destination nodes)
  col_idx.txt  — E ints (source/neighbor indices)
  labels.txt   — N ints (one class label per node), or N lines of C 0/1
                 ints each (C binary tasks, multi-label)

and, optionally, beside them:

  edge_features.txt — E lines of k floats, the features of each edge in
                      col_idx's (CSR) order (Graph.edge_features)

The dataset lives in `<root>/<name>/`, with root taken from `--data-root`,
else env `DATA_ROOT`, else `./data`.

save_dataset writes a Graph back out in this format, byte for byte as the
JAX package's writer does (edge features and multi-label labels, which
the JAX package has not, in the formats above).

Two parsers give identical arrays, chosen by the caller with
`parser="numpy"` (the default) or `parser="native"` (the multi-threaded C++
parser of native/loader.cpp, built at first use by utils/native_loader.py;
a failed build raises). There is no silent switch between them.
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


PARSERS = ("numpy", "native")


def _check_parser(parser: str) -> None:
    if parser not in PARSERS:
        raise ValueError(f"parser must be one of {PARSERS}, got {parser!r}")


def load_features(path: pathlib.Path, parser: str = "numpy") -> np.ndarray:
    """Dense [N, F] float32; N and F inferred from the file; ragged rows
    are an error."""
    _check_parser(parser)
    with open(path) as f:
        first = f.readline()
    ncols = len(first.split())
    if ncols == 0:
        raise ValueError(f"{path}: empty first row")
    if parser == "native":
        from gatv2_tpu_torch.utils import native_loader

        flat = native_loader.parse_float_file(path)
    else:
        flat = np.fromfile(path, dtype=np.float32, sep=" ")
    if flat.size % ncols != 0:
        raise ValueError(
            f"{path}: total value count {flat.size} is not a multiple of the "
            f"first row's width {ncols} (ragged rows?)"
        )
    return flat.reshape(-1, ncols)


def load_int_array(path: pathlib.Path, parser: str = "numpy") -> np.ndarray:
    """Whitespace-separated ints."""
    _check_parser(parser)
    if parser == "native":
        from gatv2_tpu_torch.utils import native_loader

        return native_loader.parse_int_file(path)
    return np.fromfile(path, dtype=np.int64, sep=" ").astype(np.int32)


def load_dataset(
    dataset: str, data_root: str | None = None, parser: str = "numpy"
) -> Graph:
    d = resolve_dataset_dir(dataset, data_root)
    if not d.is_dir():
        raise FileNotFoundError(
            f"Dataset directory not found: {d} (dataset={dataset!r}). "
            f"Expected features.txt/row_ptr.txt/col_idx.txt/labels.txt inside."
        )
    for fname in ("features.txt", "row_ptr.txt", "col_idx.txt", "labels.txt"):
        if not (d / fname).is_file():
            raise FileNotFoundError(f"Missing {fname} in {d}")
    _check_parser(parser)
    ef_path = d / EDGE_FEATURES
    return Graph(
        features=load_features(d / "features.txt", parser),
        row_ptr=load_int_array(d / "row_ptr.txt", parser),
        col_idx=load_int_array(d / "col_idx.txt", parser),
        labels=load_labels(d / "labels.txt", parser),
        edge_features=(load_features(ef_path, parser)
                       if ef_path.is_file() else None),
    )


EDGE_FEATURES = "edge_features.txt"


def load_labels(path: pathlib.Path, parser: str = "numpy") -> np.ndarray:
    """[N] int32 class labels, or [N, C] when each line holds C values
    (multi-label tasks)."""
    with open(path) as f:
        first = f.readline()
    if len(first.split()) <= 1:
        return load_int_array(path, parser)
    return load_features(path, parser).astype(np.int32)


def save_dataset(graph: Graph, directory: str | os.PathLike) -> None:
    """Write a Graph in the reference's text format: each feature as
    repr(float(v)), which reads back to the same float32; row_ptr and
    col_idx on one line each and labels one per line, with np.savetxt's
    %d."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "features.txt", "w") as f:
        for row in graph.features:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
    np.savetxt(d / "row_ptr.txt", graph.row_ptr[None], fmt="%d")
    np.savetxt(d / "col_idx.txt", graph.col_idx[None], fmt="%d")
    labels = graph.labels
    np.savetxt(d / "labels.txt", labels[:, None] if labels.ndim == 1
               else labels, fmt="%d")
    if graph.edge_features is not None:
        with open(d / EDGE_FEATURES, "w") as f:
            for row in graph.edge_features:
                f.write(" ".join(repr(float(v)) for v in row) + "\n")
