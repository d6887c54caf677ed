"""Checkpoint / resume: params + optimizer state + epoch counter (port of
gatv2_tpu/train/checkpoint.py).

One atomic npz per save, with the JAX package's keys: `p{i}` for the
parameter leaves and `o{i}` for the optimizer leaves, both in JAX's flatten
order (per layer a, w_dst, w_src, then w_o; Adam's m leaves, then its v
leaves), and `__meta__`, a JSON string holding the epoch and run_meta's
config fingerprint. The port writes no `params_treedef` / `opt_treedef`
(JAX pytree reprs): the JAX package's restore then skips its structure
check, so either package restores the other's checkpoints. Restore checks
the leaf count and every shape against the current run and fails with an
actionable message on a mismatch. Resume restores the epoch, so Adam's
epoch-indexed bias correction continues with the right t.

Multi-GPU trainers (a `mesh` attribute) save from rank 0 only
(save_trainer); a ShardedTrainer first gathers its head-sharded leaves to
full shape, so its checkpoint is the single-device format either package
restores, and restore_into re-shards each leaf onto the rank.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import tempfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from gatv2_tpu_torch.models.gatv2 import GATv2
from gatv2_tpu_torch.train.optim import init_opt_state, param_leaves


class CheckpointMismatch(ValueError):
    """Stored checkpoint does not match the current run."""


def opt_leaves(opt_state: dict) -> list[torch.Tensor]:
    """The optimizer state's leaves in JAX's flatten order ({"m", "v"},
    keys sorted); none for SGD's {}."""
    return [t for k in sorted(opt_state) for t in opt_state[k]]


def run_meta(model_config: Any = None, train_config: Any = None) -> dict:
    """Fingerprint of the configs that must match between save and resume
    (the same fields, and so the same hash, as the JAX package's)."""
    meta: dict[str, Any] = {}
    if model_config is not None:
        d = dataclasses.asdict(model_config)
        # execution knobs may differ between the saving and resuming runs
        # without changing what the params mean
        skip = {"matmul_precision", "remat", "compute_dtype", "param_dtype"}
        meta["model_config"] = {k: d[k] for k in sorted(d) if k not in skip}
    if train_config is not None:
        d = dataclasses.asdict(train_config)
        # only fields whose change breaks a resume: the optimizer family and
        # the minibatch shape (step count / bias correction)
        keep = ("optimizer", "batch_size", "fanouts")
        meta["train_config"] = {k: d[k] for k in keep if k in d}
    blob = json.dumps(meta, sort_keys=True, default=str)
    meta["config_hash"] = hashlib.sha256(blob.encode()).hexdigest()[:16]
    return meta


def save(directory: str, params: GATv2, opt_state: dict, epoch: int, *,
         meta: dict | None = None) -> pathlib.Path:
    """Write ckpt_<epoch>.npz into directory (tmp file + rename)."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)

    def flat(leaves, prefix):
        return {f"{prefix}{i}": t.detach().cpu().numpy()
                for i, t in enumerate(leaves)}

    path = d / f"ckpt_{epoch:08d}.npz"
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    os.close(fd)
    np.savez(tmp, __meta__=json.dumps({"epoch": int(epoch), **(meta or {})}),
             **flat(param_leaves(params), "p"),
             **flat(opt_leaves(opt_state), "o"))
    os.replace(tmp, path)
    return path


def save_trainer(directory: str, trainer, *,
                 meta: dict | None = None) -> pathlib.Path | None:
    """save() of a trainer's params, optimizer state and epoch. On a
    multi-GPU trainer every rank calls it: the full model is gathered
    (ShardedTrainer.full_params, a collective), rank 0 writes and the
    others wait for the file; they get None."""
    mesh = getattr(trainer, "mesh", None)
    if hasattr(trainer, "full_params"):
        params, opt = trainer.full_params(), trainer.full_opt_state()
    else:
        params, opt = trainer.params, trainer.opt_state
    path = None
    if mesh is None or mesh.rank == 0:
        path = save(directory, params, opt, trainer.epoch, meta=meta)
    if mesh is not None:
        dist.barrier(group=mesh.world)
    return path


def _copy_into(leaves, flat, prefix, *, what, path) -> None:
    stored = [k for k in flat if k.startswith(prefix)
              and k[len(prefix):].isdigit()]
    if len(stored) != len(leaves):
        raise CheckpointMismatch(
            f"{path}: checkpoint stores {len(stored)} {what} tensors but the "
            f"current run expects {len(leaves)} — the model/optimizer "
            f"configuration changed since the checkpoint was written"
        )
    for i, t in enumerate(leaves):
        arr = flat[f"{prefix}{i}"]
        if tuple(arr.shape) != tuple(t.shape):
            raise CheckpointMismatch(
                f"{path}: {what} tensor #{i} has stored shape "
                f"{tuple(arr.shape)} but the current run expects "
                f"{tuple(t.shape)} — check --num-layers/--heads/--outdims "
                f"(and the dataset's class/feature counts) against the "
                f"checkpointed run"
            )
    with torch.no_grad():
        for i, t in enumerate(leaves):
            t.copy_(torch.from_numpy(flat[f"{prefix}{i}"]))


def restore(path: str | pathlib.Path, params: GATv2,
            opt_state: dict | None = None) -> int:
    """Copy the checkpoint's values into `params` and, unless opt_state is
    None or empty (predict needs no optimizer state), into `opt_state`, in
    place and on their devices, after checking counts and shapes. Returns
    the stored epoch."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    _copy_into(param_leaves(params), flat, "p", what="parameter", path=path)
    if opt_state:
        _copy_into(opt_leaves(opt_state), flat, "o", what="optimizer",
                   path=path)
    return int(meta["epoch"])


def latest_path(directory: str) -> pathlib.Path | None:
    d = pathlib.Path(directory)
    if not d.is_dir():
        return None
    ckpts = sorted(d.glob("ckpt_*.npz"))
    return ckpts[-1] if ckpts else None


def read_meta(path: str | pathlib.Path) -> dict:
    """The checkpoint's stored metadata (epoch, config fingerprint)."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


def config_diffs(stored: dict, current: dict,
                 groups=("model_config", "train_config")) -> list[str]:
    """`group.field: stored=... current=...` for every differing field,
    after a JSON round trip of `current` (tuples -> lists)."""
    current = json.loads(json.dumps(current, default=str))
    diffs = []
    for group in groups:
        a, b = stored.get(group, {}), current.get(group, {})
        for k in sorted(set(a) | set(b)):
            if a.get(k) != b.get(k):
                diffs.append(f"{group}.{k}: stored={a.get(k)!r} "
                             f"current={b.get(k)!r}")
    return diffs


def restore_into(directory: str, trainer, *,
                 expect_meta: dict | None = None) -> bool:
    """Restore the newest checkpoint into a Trainer in place (params,
    optimizer state, epoch). True if one was restored.

    expect_meta (run_meta() of the current run): when both it and the
    stored checkpoint carry a config fingerprint, a mismatch raises
    CheckpointMismatch naming the differing fields — shapes can coincide
    while semantics differ (an edge-variant checkpoint resumed as --variant
    node)."""
    path = latest_path(directory)
    if path is None:
        return False
    if expect_meta is not None and "config_hash" in expect_meta:
        stored = read_meta(path)
        if "config_hash" in stored and (
            stored["config_hash"] != expect_meta["config_hash"]
        ):
            raise CheckpointMismatch(
                f"{path}: checkpoint was written by a different "
                f"configuration:\n  "
                + "\n  ".join(config_diffs(stored, expect_meta))
            )
    if hasattr(trainer, "load_full_state"):
        # a sharded trainer: restore the full model, then re-shard it
        params = GATv2(trainer.model_config)
        opt = init_opt_state(params, trainer.train_config.optimizer)
        trainer.epoch = restore(path, params, opt)
        trainer.load_full_state(params, opt)
        return True
    trainer.epoch = restore(path, trainer.params, trainer.opt_state)
    return True
