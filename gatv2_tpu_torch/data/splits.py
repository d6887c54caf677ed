"""Train/val/test node splits (port of gatv2_tpu/data/splits.py).

  - optional mask files `train_mask.txt` / `val_mask.txt` /
    `test_mask.txt` next to the other dataset files (whitespace 0/1 ints,
    one per node; save_split_files writes them);
  - or deterministic random splits by fractions.

Training masks the loss to train nodes (labels of other nodes become -1,
which models.gatv2.loss_and_accuracy ignores); evaluation runs one
full-graph forward and reads accuracies per split.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

MASK_FILES = ("train_mask.txt", "val_mask.txt", "test_mask.txt")


@dataclasses.dataclass(frozen=True)
class Splits:
    train: np.ndarray  # [N] bool
    val: np.ndarray  # [N] bool
    test: np.ndarray  # [N] bool

    def __post_init__(self):
        for name in ("train", "val", "test"):
            object.__setattr__(
                self, name, np.asarray(getattr(self, name), bool)
            )
        if not (self.train.shape == self.val.shape == self.test.shape):
            raise ValueError("split masks must have equal length")
        overlap = (self.train & self.val) | (self.train & self.test) | (
            self.val & self.test
        )
        if overlap.any():
            raise ValueError("split masks overlap")

    @property
    def counts(self) -> tuple[int, int, int]:
        return int(self.train.sum()), int(self.val.sum()), int(self.test.sum())

    def masked_labels(self, labels: np.ndarray, which: str = "train") -> np.ndarray:
        """Labels with every node outside the split set to -1 (the whole
        row of [N, C] multi-label labels)."""
        mask = getattr(self, which)
        if np.ndim(labels) == 2:
            mask = mask[:, None]
        return np.where(mask, labels, -1).astype(np.int32)


def random_splits(
    num_nodes: int,
    fractions: tuple[float, float, float] = (0.6, 0.2, 0.2),
    seed: int = 0,
) -> Splits:
    """Deterministic random split by fractions (train, val, test)."""
    if not np.isclose(sum(fractions), 1.0):
        raise ValueError(f"split fractions must sum to 1, got {fractions}")
    order = np.random.default_rng(seed).permutation(num_nodes)
    n_train = int(round(fractions[0] * num_nodes))
    n_val = int(round(fractions[1] * num_nodes))
    masks = [np.zeros(num_nodes, bool) for _ in range(3)]
    masks[0][order[:n_train]] = True
    masks[1][order[n_train : n_train + n_val]] = True
    masks[2][order[n_train + n_val :]] = True
    return Splits(*masks)


def load_split_files(directory: str | pathlib.Path, num_nodes: int) -> Splits | None:
    """Load mask files from a dataset directory; None if absent. A partial
    set is an error (ignoring a train mask because the test mask is missing
    would leak held-out nodes into training)."""
    d = pathlib.Path(directory)
    paths = [d / f for f in MASK_FILES]
    present = [p.exists() for p in paths]
    if not any(present):
        return None
    if not all(present):
        missing = [f for f, ok in zip(MASK_FILES, present) if not ok]
        raise FileNotFoundError(
            f"{d}: partial split masks — missing {', '.join(missing)} "
            f"(provide all three of {', '.join(MASK_FILES)}, or none)"
        )
    masks = []
    for p in paths:
        m = np.loadtxt(p, dtype=np.int64).reshape(-1)
        if m.shape[0] != num_nodes:
            raise ValueError(f"{p}: {m.shape[0]} entries != {num_nodes} nodes")
        masks.append(m != 0)
    return Splits(*masks)


def save_split_files(splits: Splits, directory: str | pathlib.Path) -> None:
    """Write the three mask files: one line of space-separated 0/1 each."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    for name, mask in zip(MASK_FILES, (splits.train, splits.val, splits.test)):
        with open(d / name, "w") as f:
            f.write(" ".join("1" if v else "0" for v in mask))
