"""The port's multi-host scene-block plan and driver on the CPU
(parallel/multihost.py, parallel/multihost_driver.py).

The plan functions against the JAX package's on tests/test_multihost.py's
block layouts and on seeded random ones: equal plans (exact: the same
integer arithmetic). Then launch_local with two CPU hosts on
tests/test_pipeline.py's synthetic workspace (CasMVSNet, seeded random
weights, mesh and DSM off), with the assertions of the JAX driver's test
(tests/test_multihost.py::test_multihost_driver_exchange), and every depth
map, confidence map and camera file byte-equal to a one-host run of the
same workspace (the same code on the same inputs in processes alike), as
is every fused block.
"""

import os
import shutil

import numpy as np
import pytest

from deep3d_aerial_tpu.parallel.multihost import assign_blocks as jassign_blocks
from deep3d_aerial_tpu.parallel.multihost import exchange_cost as jexchange_cost
from deep3d_aerial_tpu.parallel.multihost import plan_hosts as jplan_hosts
from deep3d_aerial_tpu_torch.parallel.multihost import (
    assign_blocks,
    exchange_cost,
    initialize_distributed,
    plan_hosts,
)
from tests.test_multihost import make_blocks, make_pairs


def random_layout(seed):
    """Blocks of 1-6 refs drawn from 30 views (overlapping at random), and
    3-6 pairs per view."""
    rng = np.random.default_rng(seed)
    blocks = [([0.0, 1, 0, 1, 0, 1], sorted(rng.choice(30, rng.integers(1, 7),
                                                       replace=False).tolist()))
              for _ in range(rng.integers(2, 9))]
    pairs = {v: rng.choice([u for u in range(30) if u != v], rng.integers(3, 7),
                           replace=False).tolist() for v in range(30)}
    return blocks, pairs


def same_plans(a, b):
    assert len(a) == len(b)
    for p, q in zip(a, b):
        assert (p.host_id, p.block_indices, p.ref_views, p.needed_views,
                p.owned_views, p.fetch_views) == \
            (q.host_id, q.block_indices, q.ref_views, q.needed_views,
             q.owned_views, q.fetch_views)


@pytest.mark.parametrize("n_blocks,n_hosts", [(7, 3), (6, 3), (5, 2), (4, 1)])
def test_plans_equal_the_jax_plans_on_its_layouts(n_blocks, n_hosts):
    blocks = make_blocks(n_blocks)
    pairs = make_pairs(blocks)
    assert assign_blocks(blocks, n_hosts) == jassign_blocks(blocks, n_hosts)
    plans = plan_hosts(blocks, pairs, n_hosts)
    same_plans(plans, jplan_hosts(blocks, pairs, n_hosts))
    assert exchange_cost(plans) == jexchange_cost(jplan_hosts(blocks, pairs, n_hosts))
    # tests/test_multihost.py's assertions, on the port's plan
    assert sorted(b for p in plans for b in p.block_indices) == list(range(n_blocks))
    owned = set()
    for p in plans:
        assert p.owned_views | set(p.fetch_views) == p.needed_views
        assert not (p.owned_views & set(p.fetch_views))
        assert not (owned & p.owned_views)
        owned |= p.owned_views
    if n_hosts == 1:
        assert exchange_cost(plans) == 0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_hosts", [2, 3, 5])
def test_plans_equal_the_jax_plans_on_random_layouts(seed, n_hosts):
    blocks, pairs = random_layout(seed)
    for fusion_num in (2, 10):
        same_plans(plan_hosts(blocks, pairs, n_hosts, fusion_num),
                   jplan_hosts(blocks, pairs, n_hosts, fusion_num))
    assert assign_blocks(blocks, n_hosts) == jassign_blocks(blocks, n_hosts)
    assert exchange_cost(plan_hosts(blocks, pairs, n_hosts)) == \
        jexchange_cost(jplan_hosts(blocks, pairs, n_hosts))


def test_initialize_distributed_without_a_coordinator_is_a_no_op():
    assert initialize_distributed() == (0, 1)


def test_initialize_distributed_joins_through_a_coordinator(tmp_path):
    """Two CPU hosts join one gloo group through tcp://localhost:<a free
    port> and all_reduce across it."""
    import socket

    import torch
    from torch_parallel_workers import coordinator_case

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(coordinator_case, args=(port, str(tmp_path)), nprocs=2)
    for r in range(2):
        assert torch.load(tmp_path / f"r{r}.pt") == {"got": (r, 2), "sum": 3.0}


def _config(tmp_path):
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from tests.test_pipeline import H_IMG, W_IMG

    cfg = PipelineConfig(
        image_w=W_IMG, image_h=H_IMG, image_scale=1.0,
        scene_block_size=[40.0, 40.0, 120.0], block_overlap=2.0,
        view_num=3, num_depth=32, min_interval=0.5,
        model_type="casmvsnet", allow_random_weights=True,
        fusion_num=4, geo_consist_num=2, photomatric_threshold=0.0,
        position_threshold=2.0, depth_threshold=0.05, normal_threshold=180.0,
        run_create_mesh=False, run_create_dsm=False,
    )
    path = tmp_path / "cfg.yaml"
    cfg.to_yaml(path)
    return str(path)


def test_launch_local_two_cpu_hosts_match_one_host(tmp_path):
    """Two host processes split the synthetic scene: each infers only its
    owned views, exchanges them through the shared workspace and fuses
    only its blocks; together they write every depth map once, fuse every
    block, and at least one fetch crosses hosts. Every map and fused block
    is byte-equal to a one-host run's."""
    from deep3d_aerial_tpu_torch.parallel.multihost_driver import launch_local
    from tests.test_pipeline import build_synthetic_workspace

    src = build_synthetic_workspace(tmp_path / "src")
    cfg = _config(tmp_path)
    # a host is one CPU (taskset: one intra-op thread), the same in both
    # runs: unpinned, two hosts' intra-op threads contend for every core,
    # and several threads a host stall behind other processes' load
    runs = {}
    for n in (2, 1):
        ws = tmp_path / f"hosts{n}"
        shutil.copytree(src, ws)
        runs[n] = (ws, launch_local(str(ws), cfg, n, cpus_per_host=1, device="cpu"))
    ws, agg = runs[2]
    assert agg["n_hosts"] == 2
    recs = agg["hosts"]
    owned = [set(r["owned_views"]) for r in recs]
    assert not (owned[0] & owned[1])
    mvs = ws / "dense" / "MVS"
    produced = {f for f in os.listdir(mvs) if f.endswith("_init.pfm")}
    assert len(produced) == len(owned[0] | owned[1]) == agg["total_depth_maps"]
    fused = sorted(f for f in os.listdir(ws / "dense" / "fusion") if f.endswith(".ply"))
    blocks_covered = set()
    for r in recs:
        blocks_covered.update(r["blocks"])
    assert len(fused) >= 1 and len(blocks_covered) >= len(fused)
    assert any(r["fetched_views"] for r in recs)
    assert all(r["device"] == "cpu" for r in recs)

    one = runs[1][0]
    for sub in ("dense/MVS", "dense/fusion"):
        names = sorted(os.listdir(one / sub))
        assert names == sorted(os.listdir(ws / sub)), sub
        for name in names:
            assert (ws / sub / name).read_bytes() == (one / sub / name).read_bytes(), name
    assert runs[1][1]["total_depth_maps"] == len(produced)
