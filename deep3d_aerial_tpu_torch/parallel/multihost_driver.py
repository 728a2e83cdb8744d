"""Multi-host pipeline driver: executes one host's share of the pipeline
(counterpart of the JAX package's parallel/multihost_driver.py).

Wires the deterministic plans of parallel.multihost into real multi-process
execution: every host derives the SAME plan from the view-selection
artifacts (no coordination round), infers depth maps only for the views it
OWNS, exchanges artifacts with the other hosts, then fuses only its
assigned scene blocks.

The exchange medium is the shared workspace filesystem: each view is
produced exactly once by its owner, which publishes a marker file once
every file of the view is written, and read by every host that fuses a
block referencing it. A torch.distributed process group is joined when a
coordinator address is given (parallel.multihost.initialize_distributed).

A host runs on cuda:(host_id mod the cards present), or on the CPU with
`--device cpu`; `--deterministic` sets torch.backends.cudnn.deterministic,
so that its maps are byte-equal to one host's run of the same workspace
(cuDNN's default transposed-convolution algorithms sum in an order that
varies from run to run).

Launch N local hosts:
    python -m deep3d_aerial_tpu_torch.parallel.multihost_driver \\
        --workspace WS --config cfg.yaml --n_hosts 4        # spawns workers
Single worker (what the launcher spawns):
    ... --n_hosts 4 --host_id 2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

from .multihost import initialize_distributed, plan_hosts


def _marker(ws: str, name: str) -> str:
    d = os.path.join(ws, "multihost")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)


def _wait_for(paths, timeout: float = 1800.0, poll: float = 0.5):
    t0 = time.time()
    missing = list(paths)
    while missing:
        missing = [p for p in missing if not os.path.exists(p)]
        if not missing:
            return
        if time.time() - t0 > timeout:
            raise TimeoutError(f"exchange timeout; missing: {missing[:4]}")
        time.sleep(poll)


def host_device(host_id: int, device: str = "cuda") -> str:
    """cuda:(host_id mod the cards present), or `device` when it is not
    CUDA."""
    import torch

    if device != "cuda":
        return device
    from ..pipeline.orchestrator import resolve_device

    resolve_device(device)
    return f"cuda:{host_id % torch.cuda.device_count()}"


def run_host(
    workspace: str,
    config,
    n_hosts: int,
    host_id: int,
    coordinator: Optional[str] = None,
    device: str = "cuda",
) -> dict:
    """Run this host's share -> timing/throughput record (also written to
    <workspace>/multihost/host<id>.json)."""
    from ..io import text_formats as tf
    from ..pipeline.orchestrator import AerialPipeline

    dev = host_device(host_id, device)
    if coordinator:
        initialize_distributed(coordinator, n_hosts, host_id, device=dev)

    pipe = AerialPipeline(workspace, config, device=dev)
    t_start = time.time()

    # stage 1: view selection on host 0 only (deterministic artifacts)
    sel_marker = _marker(workspace, "view_selection.done")
    if host_id == 0:
        if config.run_view_selection:
            pipe.select_view()
        open(sel_marker, "w").write("ok")
    else:
        _wait_for([sel_marker])

    blocks = tf.read_blocks(os.path.join(pipe.export_path, "blocks.txt"))
    pairs = dict(
        (ref, [s for s, _ in plist])
        for ref, plist in tf.read_view_pairs(
            os.path.join(pipe.export_path, "viewpair.txt"))
    )
    plans = plan_hosts(blocks, pairs, n_hosts,
                       fusion_num=config.fusion_num)
    mine = plans[host_id]

    # views each of MY blocks needs (refs + their fusion sources): a block
    # becomes fusable the moment these are published -- no global barrier
    block_views = {}
    for bi in mine.block_indices:
        req = set()
        for r in blocks[bi][1]:
            req.add(r)
            req.update(list(pairs.get(r, []))[:config.fusion_num])
        block_views[bi] = req

    # global view priority = earliest block (ANY host's) that needs the
    # view: every owner produces early-block views first, so early blocks
    # become fusable while later inference is still running
    view_prio = {}
    for bi, (_, refs) in enumerate(blocks):
        req = set()
        for r in refs:
            req.add(r)
            req.update(list(pairs.get(r, []))[:config.fusion_num])
        for v in req:
            view_prio[v] = min(view_prio.get(v, bi), bi)
    owned_order = sorted(mine.owned_views,
                         key=lambda v: (view_prio.get(v, 1 << 30), v))

    def publish(ref_id):
        open(_marker(workspace, f"view_{ref_id}.done"), "w").write("ok")

    # stage 3 runs CONCURRENTLY with stage 2: a fusion worker thread fuses
    # each assigned block as soon as its views land (local publishes
    # overlap remaining inference; remote fetches overlap other hosts'
    # inference)
    fuse_times = {}
    fuse_err = []

    def fusion_worker():
        try:
            pending = dict(block_views)
            while pending:
                ready = [bi for bi, req in pending.items()
                         if all(os.path.exists(
                             _marker(workspace, f"view_{v}.done"))
                             for v in req)]
                if not ready:
                    time.sleep(0.2)
                    continue
                for bi in sorted(ready):
                    pending.pop(bi)
                    t0 = time.time()
                    if config.run_depth_fusion:
                        pipe.fuse_depth_map(block_indices=[bi])
                    fuse_times[bi] = time.time() - t0
        except Exception as e:  # surfaced after join
            fuse_err.append(e)

    fuser = threading.Thread(target=fusion_worker, daemon=True)
    fuser.start()

    # stage 2: dense matching for OWNED views only, publishing per view
    t_mvs0 = time.time()
    n_owned = len(mine.owned_views)
    stub_s = float(os.environ.get("MULTIHOST_STUB_SECONDS", "0") or 0)
    if config.run_mvs:
        if stub_s > 0:
            _stub_dense_match(pipe, owned_order, stub_s, publish)
        else:
            pipe.dense_match(view_filter=mine.owned_views,
                             view_order=owned_order,
                             on_view_done=publish)
    else:
        for v in owned_order:
            publish(v)
    t_mvs = time.time() - t_mvs0
    open(_marker(workspace, f"mvs_host{host_id}.done"), "w").write("ok")

    fuser.join(timeout=1800)
    if fuser.is_alive():
        raise TimeoutError(f"host {host_id}: fusion of blocks "
                           f"{sorted(set(block_views) - set(fuse_times))} did not end")
    if fuse_err:
        raise fuse_err[0]
    t_end = time.time()

    record = {
        "host_id": host_id,
        "n_hosts": n_hosts,
        "device": str(dev),
        "blocks": mine.block_indices,
        "owned_views": sorted(mine.owned_views),
        "fetched_views": {str(k): v for k, v in mine.fetch_views.items()},
        "n_depth_maps": n_owned,
        "mvs_seconds": t_mvs,
        "fuse_seconds": sum(fuse_times.values()),
        "overlap_seconds": max(0.0, t_mvs + sum(fuse_times.values())
                               - (t_end - t_start)),
        "total_seconds": t_end - t_start,
        "maps_per_s": (n_owned / t_mvs) if t_mvs > 0 and n_owned else 0.0,
    }
    with open(_marker(workspace, f"host{host_id}.json"), "w") as f:
        json.dump(record, f, indent=1)
    return record


def _stub_dense_match(pipe, owned_views, seconds_per_map, publish):
    """Deterministic compute stand-in: per owned view, sleep a fixed
    `seconds_per_map` then write a synthetic mid-range depth plane + full
    confidence (real artifact path, real cam txt). Makes per-map cost
    constant across hosts so N-host runs measure STRUCTURAL efficiency
    (plan imbalance + exchange + barrier), not contention."""
    import numpy as np

    from ..io import text_formats as tf
    from ..io.pfm import write_pfm
    from ..pipeline.dataset import EvalDataset

    cfg = pipe.cfg
    ds = EvalDataset(pipe.export_path, view_num=cfg.view_num,
                     num_depth=cfg.num_depth, resize_scale=cfg.image_scale,
                     max_h=cfg.max_h, max_w=cfg.max_w)
    idx_by_ref = {s[0]: i for i, s in enumerate(ds.samples)}
    for ref_id in owned_views:
        s = ds.build(idx_by_ref[ref_id])
        time.sleep(seconds_per_map)
        H, W = s.imgs.shape[1:3]
        mid = 0.5 * (s.depth_min + s.depth_max)
        write_pfm(os.path.join(pipe.mvs_path, f"{s.ref_name}_init.pfm"),
                  np.full((H, W), mid, np.float32))
        write_pfm(os.path.join(pipe.mvs_path, f"{s.ref_name}_prob.pfm"),
                  np.ones((H, W), np.float32))
        tf.write_mvs_cam(os.path.join(pipe.mvs_path, f"{s.ref_name}.txt"),
                         s.ref_cam)
        publish(ref_id)


def launch_local(workspace: str, config_path: str, n_hosts: int,
                 cpus_per_host: int = 0, device: str = "cuda",
                 deterministic: bool = False) -> dict:
    """Spawn n_hosts worker processes against a shared workspace; aggregate
    throughput. N processes on one machine are the local stand-in for N
    hosts; host h runs on cuda:(h mod the cards present), or on `device`
    when it is not CUDA. `deterministic` passes --deterministic.

    cpus_per_host > 0 pins each worker to its own CPU set (taskset; host h
    takes the h-th run of cpus_per_host of the CPUs this process may use),
    so 'a host' is a FIXED resource and 1-vs-N throughput measures scaling
    rather than core contention (on the CPU, hosts that share the cores
    also share them with each other's intra-op threads)."""
    allowed = sorted(os.sched_getaffinity(0))
    if cpus_per_host * n_hosts > len(allowed):
        raise ValueError(f"{n_hosts} hosts of {cpus_per_host} CPUs: only "
                         f"{len(allowed)} CPUs available")
    procs = []
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    for h in range(n_hosts):
        cmd = [sys.executable, "-m",
               "deep3d_aerial_tpu_torch.parallel.multihost_driver",
               "--workspace", workspace, "--config", config_path,
               "--n_hosts", str(n_hosts), "--host_id", str(h),
               "--device", device]
        if deterministic:
            cmd.append("--deterministic")
        if cpus_per_host > 0:
            cpus = ",".join(str(c) for c in allowed[
                h * cpus_per_host:(h + 1) * cpus_per_host])
            cmd = ["taskset", "-c", cpus] + cmd
        procs.append(subprocess.Popen(cmd, env=env))
    # a host that fails ends the others: they would wait for its views
    while any(p.poll() is None for p in procs):
        if any(p.poll() for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.2)
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise RuntimeError(f"worker exit codes: {rcs}")
    records = [
        json.load(open(_marker(workspace, f"host{h}.json")))
        for h in range(n_hosts)
    ]
    total_maps = sum(r["n_depth_maps"] for r in records)
    wall = max(r["total_seconds"] for r in records)
    agg = {
        "n_hosts": n_hosts,
        "total_depth_maps": total_maps,
        "wall_seconds": wall,
        "agg_maps_per_s": total_maps / wall if wall else 0.0,
        "hosts": records,
    }
    with open(_marker(workspace, "aggregate.json"), "w") as f:
        json.dump(agg, f, indent=1)
    return agg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--n_hosts", type=int, default=1)
    ap.add_argument("--host_id", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (host h on cuda:h mod the cards) or cpu")
    ap.add_argument("--deterministic", action="store_true",
                    help="cuDNN's deterministic algorithms (byte-equal maps)")
    args = ap.parse_args(argv)

    from ..pipeline.config import PipelineConfig

    cfg = PipelineConfig.from_yaml(args.config)
    if args.host_id is None:
        agg = launch_local(args.workspace, args.config, args.n_hosts,
                           device=args.device, deterministic=args.deterministic)
        print(json.dumps({k: v for k, v in agg.items() if k != "hosts"}))
    else:
        if args.deterministic:
            import torch

            torch.backends.cudnn.deterministic = True
        rec = run_host(args.workspace, cfg, args.n_hosts, args.host_id,
                       args.coordinator, device=args.device)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
