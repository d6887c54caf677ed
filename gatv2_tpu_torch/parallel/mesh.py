"""The rank mesh of sharded training (port of gatv2_tpu/parallel/mesh.py)
on torch.distributed process groups.

A mesh of `num_ranks` ranks is G x H: the 'graph' axis carries the edge
partition, the 'head' axis (head_shards = H > 1) tensor parallelism over
attention heads. As in the JAX package the head axis is innermost: rank r
sits at graph coordinate r // H and head coordinate r % H, so a head
group is H consecutive ranks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a G x H mesh and its groups: `graph` spans the
    ranks of its head coordinate (G ranks), `head` those of its graph
    coordinate (H ranks), `world` the whole mesh."""

    rank: int
    graph_size: int
    head_size: int
    graph: object  # ProcessGroup
    head: object
    world: object
    device: torch.device

    @property
    def graph_index(self) -> int:
        return self.rank // self.head_size

    @property
    def head_index(self) -> int:
        return self.rank % self.head_size


def make_mesh(num_ranks: int, *, device: torch.device | str,
              head_shards: int = 1) -> Mesh | None:
    """The mesh over the first `num_ranks` ranks of the process group.
    Every rank of the group must call it, in the same order, since each
    group is created collectively; ranks outside the mesh get None.
    `device` is this rank's (multihost.rank_device gives cuda:(local_rank
    % device_count), or the CPU when asked)."""
    world = dist.get_world_size()
    n = num_ranks
    if n > world:
        raise ValueError(f"requested {n} ranks, only {world} available")
    if head_shards < 1 or n % head_shards:
        raise ValueError(
            f"{n} ranks not divisible by head_shards={head_shards}")
    g_size = n // head_shards
    graph_groups = [
        dist.new_group([g * head_shards + h for g in range(g_size)])
        for h in range(head_shards)
    ]
    head_groups = [
        dist.new_group([g * head_shards + h for h in range(head_shards)])
        for g in range(g_size)
    ]
    mesh_group = dist.group.WORLD if n == world else dist.new_group(
        list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    return Mesh(
        rank=rank, graph_size=g_size, head_size=head_shards,
        graph=graph_groups[rank % head_shards],
        head=head_groups[rank // head_shards], world=mesh_group,
        device=torch.device(device),
    )
