"""Multi-host scene partitioning (counterpart of the JAX package's
parallel/multihost.py; the cross-host axis of SURVEY section 2.10).

Scene blocks are the unit of host parallelism: each host runs dense matching
+ fusion for its assigned blocks; views shared across block boundaries are
owned by one of the hosts that need them and exchanged as depth-map
artifacts (the shared workspace's files: parallel/multihost_driver.py).

This module holds the deterministic partitioning/ownership logic (pure,
unit-testable; `HostPlan`, `assign_blocks`, `plan_hosts` and
`exchange_cost` are the JAX package's, line for line);
`initialize_distributed` joins a torch.distributed process group for real
multi-process runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass
class HostPlan:
    host_id: int
    block_indices: List[int]
    ref_views: Set[int]  # ref views this host infers depth for
    needed_views: Set[int]  # all views this host's fusion reads
    owned_views: Set[int]  # views this host is responsible for producing
    fetch_views: Dict[int, int]  # view -> owner host to fetch from


def assign_blocks(
    blocks: Sequence[Tuple[Sequence[float], Sequence[int]]],
    n_hosts: int,
) -> List[List[int]]:
    """Balanced block -> host assignment (largest-first by ref count)."""
    order = sorted(range(len(blocks)), key=lambda i: -len(blocks[i][1]))
    loads = [0] * n_hosts
    assign: List[List[int]] = [[] for _ in range(n_hosts)]
    for bi in order:
        h = min(range(n_hosts), key=lambda k: loads[k])
        assign[h].append(bi)
        loads[h] += max(1, len(blocks[bi][1]))
    for lst in assign:
        lst.sort()
    return assign


def plan_hosts(
    blocks: Sequence[Tuple[Sequence[float], Sequence[int]]],
    pairs: Dict[int, Sequence[int]],
    n_hosts: int,
    fusion_num: int = 10,
) -> List[HostPlan]:
    """Full multi-host plan: assignment + view ownership + exchange lists.

    Ownership rule: each view is owned by exactly one of the hosts that
    need it, chosen to BALANCE inference load (fewest owned views so far,
    ties to the lowest host id). Deterministic — every host derives the
    same plan independently, no coordination round needed. (A plain
    lowest-host rule piles every shared view onto host 0 in overlapping
    scenes and serializes the MVS stage.)
    """
    assign = assign_blocks(blocks, n_hosts)

    needed: List[Set[int]] = []
    refs: List[Set[int]] = []
    for h in range(n_hosts):
        need: Set[int] = set()
        ref_set: Set[int] = set()
        for bi in assign[h]:
            for r in blocks[bi][1]:
                ref_set.add(r)
                need.add(r)
                need.update(list(pairs.get(r, []))[:fusion_num])
        needed.append(need)
        refs.append(ref_set)

    owner: Dict[int, int] = {}
    loads = [0] * n_hosts
    all_views = sorted(set().union(*needed)) if needed else []
    for v in all_views:
        cands = [h for h in range(n_hosts) if v in needed[h]]
        h = min(cands, key=lambda k: (loads[k], k))
        owner[v] = h
        loads[h] += 1

    plans = []
    for h in range(n_hosts):
        owned = {v for v in needed[h] if owner[v] == h}
        fetch = {v: owner[v] for v in needed[h] if owner[v] != h}
        plans.append(HostPlan(
            host_id=h,
            block_indices=assign[h],
            ref_views=refs[h],
            needed_views=needed[h],
            owned_views=owned,
            fetch_views=fetch,
        ))
    return plans


def exchange_cost(plans: Sequence[HostPlan]) -> int:
    """Total number of cross-host depth-map transfers (DCN traffic proxy)."""
    return sum(len(p.fetch_views) for p in plans)


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> Tuple[int, int]:
    """Join the process group of `num_processes` hosts through
    tcp://<coordinator> (host:port) as `process_id` -> (process_id,
    num_processes): NCCL on a CUDA device, gloo on the CPU, by
    launch.init_rank (which makes this host's card current first).

    No-op single-process fallback when no coordinator is configured.
    """
    if coordinator is None:
        return 0, 1
    import torch
    import torch.distributed as dist

    from .launch import default_backend, init_rank

    # a card named by index (multihost_driver's cuda:{host_id % cards})
    # is this host's local rank
    init_rank(process_id, num_processes, default_backend(device), device,
              f"tcp://{coordinator}", local_rank=torch.device(device).index)
    return dist.get_rank(), dist.get_world_size()
