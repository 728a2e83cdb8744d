"""The benchmark's harness, driven by data.

A cell of BENCHMARK.json names a configuration (configs/<name>.json: the
model and its sizes, as the port's constructors take them) and a traffic
mix (traffic/<name>.json: its loop, 'infer' or 'train', and the loop's
parameters). Its correctness limits are limits/<cell>.json, each
per-layer or end-to-end metric is read by metrics/<metric>.py, and the
kernels' work is counted by work/. Nothing here lists them: they are found
by the names in BENCHMARK.json.

One run: set-up (a seeded survey rendered on the device and written where
the port's loaders read it, the port's samples or batches built from it,
the model with seeded weights, the cell's shapes warmed up), a closed-loop
window of `seconds` through the port's own entry (AerialPipeline's
_infer_batch, or the trainer's step), with --trace a profiled segment of
whole maps or steps after it, then the comparison with the plain
reference (reference/), once the program's state is freed.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import shutil
import statistics
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import survey, trace
from .reference import inputs as ref_inputs
from .reference import nets as ref_nets
from .reference import train as ref_train
from .weights import seeded
from .work import peaks

ROOT = Path(__file__).resolve().parent


def benchmark() -> Dict:
    return json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def load(kind: str, name: str) -> Dict:
    """configs/, traffic/ or limits/<name>.json."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def reader(name: str) -> Callable[[Dict], Optional[float]]:
    """metrics/<name>.py's read(record)."""
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("mvsbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, workload: str, traced: bool) -> List[Dict]:
    """The metrics a run of `workload` reports: the end-to-end ones
    untraced, the per-layer ones traced (each where its `workloads` names
    the cell, or everywhere without the key)."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def peak_flops(cfg: Dict) -> float:
    return peaks.BF16 if cfg["model"].get("dtype") == "bfloat16" else peaks.TF32X3


class Run:
    """One run's settings and what it records for the metric readers."""

    def __init__(self, workload: str, cfg: Dict, traffic: Dict, seed: int,
                 seconds: float, traced: bool, device, t_start: float):
        self.workload = workload
        self.cfg = cfg
        self.traffic = traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = traced
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.t_start = t_start
        self.tmp = Path(tempfile.mkdtemp(prefix="mvsbench-"))
        self.rec: Dict = {"loop": traffic["loop"], "spans": None, "trace": None}
        self.control = False

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def geo(self, H: int, W: int, weights: Dict) -> Dict:
        m = self.cfg["model"]
        return {"model": self.cfg["model_type"], "base": m["base_channels"],
                "views": self.cfg["view_num"], "H": H, "W": W,
                "ndepths": list(m["ndepths"]), "chunk": m["plane_chunk"],
                "reg_weights": [sum(t.numel() for n, t in weights.items()
                                    if n.startswith(f"red{s}."))
                                for s in range(len(m["ndepths"]))]}

    def model(self, weights_seed: int):
        """The port's model with seeded weights on the device, and the
        weights (the benchmark's, handed to the reference too)."""
        from deep3d_aerial_tpu_torch.models import build_model

        kw = dict(self.cfg["model"])
        model = build_model(self.cfg["model_type"], **kw).to(self.dev)
        shapes = {n: t.shape for n, t in model.state_dict().items()}
        weights = seeded(shapes, weights_seed, self.dev)
        model.load_state_dict(weights)
        return model, weights

    def window(self, call: Callable[[int], bool]) -> None:
        """The closed loop: call(i) for i = 0, 1, ... until `seconds` have
        passed; call returns whether the map or step succeeded (a raise
        counts as a failure)."""
        self.sync()
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        self.rec["setup_s"] = t0 - self.t_start
        lat, failed, i = [], 0, 0
        while True:
            a = time.perf_counter()
            try:
                ok = call(i)
            except Exception:  # a failed map or step: counted, and the loop goes on
                traceback.print_exc()
                ok = False
            b = time.perf_counter()
            lat.append(b - a)
            failed += not ok
            i += 1
            if b - t0 >= self.seconds:
                break
        self.rec.update(window_s=b - t0, latencies=lat, attempted=i, failed=failed,
                        count=i - failed,
                        peak_bytes=torch.cuda.max_memory_allocated(self.dev)
                        if self.cuda else 0)

    def profile(self, marks: trace.Marks, one: Callable[[int], None], n: int) -> None:
        """The traced segment: n whole maps or steps in one profiler session,
        each phase a host range."""
        self.rec["spans"] = marks.ms()
        marks.ranges = True

        def run():
            for i in range(n):
                one(i)
                marks.close()
        self.rec["trace"] = trace.profiled(run)
        self.rec["traced"] = n
        marks.ranges = False

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


class _Marked(torch.nn.Module):
    """The model with the benchmark's marks at its phase boundaries."""

    def __init__(self, model, marks: trace.Marks):
        super().__init__()
        self.model = model
        self.marks = marks

    def forward(self, *args):
        self.marks.begin()
        return self.model(*args, mark=self.marks)


def _frames(run: Run, sv: survey.Survey):
    frames, depths, ranges = [], [], []
    for v in range(len(sv.centers)):
        f, d = survey.render(sv, v, run.dev)
        frames.append(f)
        depths.append(d)
        ranges.append(survey.depth_range(d))
    return frames, depths, ranges


# ------------------------------------------------------------------ infer
def infer_loop(run: Run) -> Dict:
    """Dense matching at the frame of the configuration: maps through
    AerialPipeline._infer_batch, closed loop over a pool of reference
    views; the check compares a seeded sample of the window's maps with the
    reference."""
    from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
    from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline

    cfg, tr = run.cfg, run.traffic
    H, W = int(cfg["image_h"] * cfg["image_scale"]), int(cfg["image_w"] * cfg["image_scale"])
    if run.cuda:  # as dense_match sets it: float32 convolutions stay float32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    sv = survey.survey(W, H, tr["survey"][0], tr["survey"][1], run.seed)
    frames, _, ranges = _frames(run, sv)
    ws = run.tmp / "ws"
    survey.write_export(ws, sv, frames, ranges, cfg["view_num"])
    m = cfg["model"]
    pcfg = PipelineConfig(image_w=cfg["image_w"], image_h=cfg["image_h"],
                          image_scale=cfg["image_scale"], view_num=cfg["view_num"],
                          num_depth=m["num_depth"], model_type=cfg["model_type"],
                          ndepths=list(m["ndepths"]),
                          depth_ratios=list(m["depth_interval_ratios"]),
                          compute_dtype=m.get("dtype", "float32"),
                          warp_precision=m.get("warp_precision", "float32"),
                          infer_batch_size=tr["batch"])
    pipe = AerialPipeline(str(ws), pcfg, device=run.dev)
    ds = pipe.eval_dataset()
    n = min(tr["pool"], len(ds))
    with ThreadPoolExecutor(max_workers=4) as ex:
        pool = list(ex.map(ds.build, range(n)))
    model, weights = run.model(run.seed)
    model.eval()
    marks = trace.Marks(events=run.traced)
    fwd = _Marked(model, marks) if run.traced else model
    B = tr["batch"]

    def batch(i):
        return [pool[(i * B + k) % n] for k in range(B)]
    for i in range(tr["warm"]):
        pipe._infer_batch(fwd, batch(i))
        marks.close()
    marks.per.clear()
    # a seeded sample of the window's maps (reservoir), kept for the check
    rng, keep, seen = random.Random(run.seed), [], 0

    def call(i):
        nonlocal seen
        samples = batch(i)
        depth, conf, _, n_bad = pipe._infer_batch(fwd, samples)
        marks.close()
        for k, s in enumerate(samples):
            item = (s.ref_id, depth[k], conf[k])
            if len(keep) < tr["check_maps"]:
                keep.append(item)
            else:
                j = rng.randrange(seen + 1)
                if j < len(keep):
                    keep[j] = item
            seen += 1
        return not any(n_bad)
    run.window(call)
    run.rec["samples"] = run.rec["count"] * B
    if run.traced:
        run.profile(marks, lambda i: pipe._infer_batch(fwd, batch(i)), tr["trace_maps"])
    run.rec["geo"] = run.geo(H, W, weights)
    del pipe, ds, pool, model, fwd
    if run.cuda:
        torch.cuda.empty_cache()
    return infer_check(run, ws, frames, weights, keep)


def infer_check(run: Run, ws: Path, frames, weights, keep) -> Dict:
    """The reference at the full frame on each kept map's raw inputs:
    the widest depth gap (a share of the depth range) and confidence gap
    over the kept maps. With `run.control`, the same gaps of the
    reference computed with TF32 on (the control) against it."""
    cfg = run.cfg
    export = ref_inputs.read_export(ws / "export", cfg["view_num"])
    names = ("depth_gap", "conf_gap", "depth_mean_gap", "conf_mean_gap")
    gaps = {n: 0.0 for n in names}
    if run.control:
        gaps.update({f"control.{n}": 0.0 for n in names})
    if not keep:
        return {n: math.inf for n in gaps}
    t0 = time.perf_counter()

    def reference(imgs, rel, dmin, dmax, tf32):
        ref_nets.precision(tf32)
        with torch.no_grad():
            out = ref_nets.forward(cfg["model_type"], weights, torch.from_numpy(imgs).to(run.dev),
                                   torch.from_numpy(rel).to(run.dev), dmin, dmax, cfg["model"])
        ref_nets.precision(False)
        return [t.cpu().numpy() for t in ref_nets.final(out)]

    def widen(prefix, depth, conf, d, c, span):
        dd, dc = np.abs(depth - d) / span, np.abs(conf - c)
        for name, v in (("depth_gap", dd.max()), ("conf_gap", dc.max()),
                        ("depth_mean_gap", dd.mean()), ("conf_mean_gap", dc.mean())):
            gaps[prefix + name] = max(gaps[prefix + name], float(v))
    for ref_id, depth, conf in keep:
        imgs, rel, dmin, dmax = ref_inputs.infer_inputs(export, by_id(frames), ref_id)
        d, c = reference(imgs, rel, dmin, dmax, tf32=False)
        widen("", depth, conf, d, c, dmax - dmin)
        if run.control:
            widen("control.", *reference(imgs, rel, dmin, dmax, tf32=True), d, c, dmax - dmin)
    gaps["check_s"] = time.perf_counter() - t0
    return gaps


# ------------------------------------------------------------------ train
def pair_weight(cfg: Dict) -> float:
    """The pair loss's weight, as the trainer CLI sets it: 1 for AdaMVS."""
    return 1.0 if cfg["model_type"] == "adamvs" else 0.0


def train_loop(run: Run) -> Dict:
    """Training at the trainer CLI's defaults: the Trainer's step (the
    model, the loss and RMSprop as train/cli.py builds them) on batches
    of the port's WHU-OMVS loader, closed loop. Its first steps, in
    set-up, go through the same call on distinct samples, and the check
    compares them with the reference's."""
    from deep3d_aerial_tpu_torch.train.dataset_whu import WHUOMVSDataset
    from deep3d_aerial_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg, tr = run.cfg, run.traffic
    H, W = tr["frame"]
    sv = survey.survey(W, H, tr["survey"][0], tr["survey"][1], run.seed)
    frames, depths, ranges = _frames(run, sv)
    refs = list(range(tr["pool"]))
    root = run.tmp / "train"
    survey.write_whu(root, sv, frames, depths, ranges, refs, cfg["view_num"])
    ds = WHUOMVSDataset(str(root), view_num=cfg["view_num"], max_h=H, max_w=W,
                        gt_format="pfm")
    batches = list(ds.batches(tr["batch"], shuffle=False))
    model, weights = run.model(run.seed)
    tcfg = TrainerConfig(lr=tr["lr"], lr_epochs=tr["lr_epochs"], batch_size=tr["batch"],
                         ckpt_dir=str(run.tmp / "ckpt"), optimizer=tr["optimizer"],
                         pair_weight=pair_weight(cfg), tb_logdir=None)
    trainer = Trainer(model, tcfg, steps_per_epoch=max(1, len(ds) // tr["batch"]),
                      device=run.dev)
    opt, step = trainer.optimizer, trainer.step_fn
    marks = trace.Marks(events=run.traced)
    nb = len(batches)
    first = tr["first_steps"]
    logs, grad1 = [], {}

    def one(i):
        if run.traced:
            marks.begin()
            out = step(batches[i % nb], mark=marks)
        else:
            out = step(batches[i % nb])
        marks.close()
        return out
    # the first steps: the window's own call on distinct samples, and the
    # warm-up of every shape
    for i in range(first):
        logs.append(one(i)["total"])
        if i == 0:
            grad1 = {n: float(torch.sqrt(nu.double().sum() / (1 - 0.9))) for n, nu in opt.nu.items()}
    change = {n: float((t.detach() - weights[n]).norm()) for n, t in opt.params.items()}
    marks.per.clear()
    run.window(lambda i: bool(np.isfinite(one(first + i)["total"])))
    run.rec["samples"] = run.rec["count"] * tr["batch"]
    if run.traced:
        run.profile(marks, lambda i: one(first + i), tr["trace_steps"])
    run.rec["geo"] = run.geo(H, W, weights)
    run.rec["geo"]["train"] = True
    del trainer, model, opt, step
    if run.cuda:
        torch.cuda.empty_cache()
    program = {"losses": logs, "grad1": grad1, "change": change}
    ref_batches = [ref_inputs.train_inputs(root / "scene", by_id(frames), by_id(depths),
                                           r + 1, [j + 1 for j in sv.nearest(r, cfg["view_num"] - 1)])
                   for r in refs[:first]]
    return train_check(run, program, weights, ref_batches)


def by_id(items: List) -> Dict:
    """A list of per-view items keyed by the files' 1-based view ids."""
    return {i + 1: x for i, x in enumerate(items)}


def train_check(run: Run, program: Dict, weights: Dict, samples: List[Dict]) -> Dict:
    """Each first step's loss, the first gradient's norm and the norm of
    the parameters' change after the first steps, leaf by leaf, against the
    reference's from the same weights on the same raw samples; the worst
    leaf of each. Leaves whose reference gradient is under a thousandth of
    the median leaf's are left out."""
    def follow(tf32):
        ref_nets.precision(tf32)
        try:
            return ref_train.follow(run.cfg["model_type"], weights, samples, run.cfg["model"],
                                    run.traffic["lr"], pair_weight(run.cfg), run.dev)
        finally:
            ref_nets.precision(False)
    t0 = time.perf_counter()
    ref = follow(False)
    gaps = train_gaps(program, ref)
    gaps["check_s"] = time.perf_counter() - t0
    if run.control:
        gaps.update({f"control.{k}": v for k, v in train_gaps(follow(True), ref).items()})
    return gaps


def train_gaps(program: Dict, ref: Dict) -> Dict:
    """The gaps of `program`'s readings from `ref`'s: each step's loss
    (relative), and by the worst leaf the first gradient's norm and the
    change's norm, each against the larger of the reference's norm of that
    leaf and of the median leaf."""
    steps = [abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"])]
    med_g = statistics.median(ref["grad1"].values())
    leaves = [n for n, g in ref["grad1"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][n] for n in leaves)

    def gaps(prog, refd, med):
        return {n: abs(prog[n] - refd[n]) / max(refd[n], med) for n in leaves}
    g, c = gaps(program["grad1"], ref["grad1"], med_g), gaps(program["change"], ref["change"], med_c)
    out = {"first_loss_gap": steps[0], "loss_gap": max(steps)}
    out.update({f"loss_gap.step{i + 1}": v for i, v in enumerate(steps)})
    out.update(grad_gap=max(g.values()), change_gap=max(c.values()),
               grad_worst_leaf=max(g, key=g.get), change_worst_leaf=max(c, key=c.get),
               change_median_gap=statistics.median(c.values()),
               leaves_left_out=len(ref["grad1"]) - len(leaves))
    return out


LOOPS = {"infer": infer_loop, "train": train_loop}


def run(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
        t_start: Optional[float] = None, overrides: Optional[Dict] = None,
        control: bool = False):
    """One run of a cell: (the result line as a dict, every number the
    check read, compared or not; with `control`, also those of the
    reference in TF32, the control, against it). `overrides` (tests)
    updates the configuration and the traffic: {'config': {...}, 'model':
    {...}, 'traffic': {...}}."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark()
    wl = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg, tr = load("configs", wl["config"]), load("traffic", wl["traffic"])
    limits = load("limits", workload)
    for key, d in (overrides or {}).items():
        {"config": cfg, "model": cfg["model"], "traffic": tr}[key].update(d)
    r = Run(workload, cfg, tr, seed, seconds, traced, device, t_start)
    r.control = control
    try:
        readings = LOOPS[tr["loop"]](r)
    finally:
        r.close()
    rec = r.rec
    rec["peak_flops"] = peak_flops(cfg)
    metrics = {}
    for m in cell_metrics(bench, workload, traced):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if r.cuda else r.dev.type,
                   "kind": torch.cuda.get_device_name(r.dev) if r.cuda else "cpu",
                   "count": 1, "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device_info}
    if traced and rec["trace"] is not None:
        t = rec["trace"]
        device_info["busy_s"] = trace.busy_us(t["device"], t["window"]) / 1e6
        device_info["window_s"] = trace.window_s(t)
        out["breakdown"] = trace.breakdown(t)
    if r.cuda:
        device_info["card"] = card()
    out["checks"] = checks
    return out, readings


def card() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None
