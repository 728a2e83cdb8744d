"""A whole forward's work, from the cell's shapes: the convolutions of the
feature net and of the pair hourglass (2 Ci Co taps x output pixels, a
transposed conv's taps per input pixel; pointwise math left out), and the
sweeps and recurrent steps through their kernels' work functions.

`geo` holds the shapes: model ('adamvs' | 'msrednet'), base (the feature
width b), views (V, the reference included), H and W (the frame),
ndepths (planes per stage), chunk (planes a sweep launch at most) and
reg_weights (the parameter count of each stage's regulariser).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import peaks, red_step2, red_step4, sweep
from .conv import flops as conv_flops
from .conv import out_hw


def stage_hw(geo: Dict) -> List[Tuple[int, int]]:
    """Each stage's feature size: 1/4, 1/2 and 1/1 of the frame."""
    h1 = out_hw(geo["H"], geo["W"], 2)
    h2 = out_hw(*h1, 2)
    return [h2, h1, (geo["H"], geo["W"])]


def channels(geo: Dict) -> List[int]:
    b = geo["base"]
    return [4 * b, 2 * b, b]


def feature_flops(geo: Dict) -> int:
    """The feature pyramid over every view ('branch' for AdaMVS, 'unet'
    for MSREDNet)."""
    b, V = geo["base"], geo["views"]
    (H2, W2), (H1, W1), (H, W) = stage_hw(geo)
    f = (conv_flops(3, b, 3, H, W) + conv_flops(b, b, 3, H, W)
         + conv_flops(b, 2 * b, 5, H, W, 2) + 2 * conv_flops(2 * b, 2 * b, 3, H1, W1)
         + conv_flops(2 * b, 4 * b, 5, H1, W1, 2) + 2 * conv_flops(4 * b, 4 * b, 3, H2, W2))
    # decoder: transposed 2x, then the fuse conv over [up, skip]
    f += (conv_flops(4 * b, 2 * b, 3, H2, W2, transposed=True)
          + conv_flops(4 * b, 2 * b, 3, H1, W1)
          + conv_flops(2 * b, b, 3, H1, W1, transposed=True)
          + conv_flops(2 * b, b, 3, H, W))
    heads = [(4 * b, H2, W2), (2 * b, H1, W1), (b, H, W)]
    for c, h, w in heads:
        if geo["model"] == "adamvs":  # 'branch': two pooled 1x1 branches
            cbr = c // 2
            f += sum(conv_flops(c, cbr, 1, h // p, w // p) for p in (4, 8))
            f += conv_flops(c + 2 * cbr, c, 1, h, w)
        else:
            f += conv_flops(c, c, 1, h, w)
    return V * f


def sweep_launches(geo: Dict) -> List[Tuple[int, Tuple[int, int]]]:
    """(launches, (bytes, operations) a launch) of the sweeps of a map."""
    V = geo["views"] - 1
    out = []
    hw, ch = stage_hw(geo), channels(geo)
    if geo["model"] == "adamvs":
        H, W = hw[0]
        out.append((1, sweep.corr(V, geo["ndepths"][0], H, W, ch[0])))
    mode = sweep.cost if geo["model"] == "adamvs" else sweep.var
    for (H, W), C, D in zip(hw, ch, geo["ndepths"]):
        K = max(k for k in range(1, min(geo["chunk"], D) + 1) if D % k == 0)
        out.append((D // K, mode(V, K, H, W, C)))
    return out


def reg_steps(geo: Dict, fold: bool = True) -> List[Tuple[int, Tuple[int, int]]]:
    """(steps, (bytes, operations) a step) of the recurrent regulariser of
    each stage (K3 for AdaMVS, folding the softmax when `fold`; K4 with K5
    for MSREDNet)."""
    out = []
    for s, ((H, W), C, D) in enumerate(zip(stage_hw(geo), channels(geo), geo["ndepths"])):
        n = geo["reg_weights"][s]
        if geo["model"] == "adamvs":
            out.append((D, red_step2.step(C, H, W, s < len(geo["ndepths"]) - 1, n, fold)))
        else:
            out.append((D, red_step4.step(C, H, W, n)))
    return out


def pair_flops(geo: Dict) -> int:
    """AdaMVS's pair branch: K1 and the 2-D hourglass over the V-1 volumes
    (planes as channels); 0 for MSREDNet."""
    if geo["model"] != "adamvs":
        return 0
    c, n = geo["ndepths"][0], geo["views"] - 1
    H, W = stage_hw(geo)[0]
    sizes = [(H, W)]
    for _ in range(3):
        sizes.append(out_hw(*sizes[-1], 2))
    f = 2 * conv_flops(c, c, 3, H, W)                      # convs 0 and prob
    for (h, w), (hs, ws) in zip(sizes[:3], sizes[1:]):
        f += conv_flops(c, c, 3, h, w, 2) + conv_flops(c, c, 3, hs, ws)
        f += conv_flops(c, c, 3, hs, ws, transposed=True)
    H1, W1 = stage_hw(geo)[0]
    return n * f + sweep.corr(n, c, H1, W1, channels(geo)[0])[1]


def phase_flops(geo: Dict, fold: bool = True) -> Dict[str, int]:
    """Operations of one forward by phase: features, pair (AdaMVS), and
    per stage its sweep launches and its regulariser steps."""
    out = {"features": feature_flops(geo)}
    if geo["model"] == "adamvs":
        out["pair"] = pair_flops(geo)
    sweeps = sweep_launches(geo)[1:] if geo["model"] == "adamvs" else sweep_launches(geo)
    for s, ((n, (_, sf)), (m, (_, rf))) in enumerate(zip(sweeps, reg_steps(geo, fold))):
        out[f"stage{s + 1}"] = n * sf + m * rf
    return out


def forward_flops(geo: Dict) -> int:
    return sum(phase_flops(geo).values())


def least_ms(launches: List[Tuple[int, Tuple[int, int]]], peak: float) -> float:
    """The least milliseconds of a list of (count, (bytes, operations))."""
    return sum(n * peaks.least_ms(b, f, peak) for n, (b, f) in launches)
