"""Map rates of the four main paths (chip_smoke.phase_main_path, 384x512,
one line per model), for comparing two checkouts on one card: run it from
each checkout's root in turn (parent, change, change, parent, ...); it
imports the chip_smoke.py and the package of the directory it runs in.

    cd CHECKOUT && python3 /path/to/scripts/paired_main_rates.py parent|change [DTYPE]

DTYPE is the pipeline's compute_dtype, float32 (the default, and the only
one a checkout from before the bfloat16 modes takes) or bfloat16: run
float32 and bfloat16 in turns from one checkout to compare the two.
Prints `PAIR <label> <model> <maps/s>` per model (median over maps 2..6 of
run_dense's host-clock seconds a map), with the dtype after the label when
one is given. Needs a CUDA device.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))
import chip_smoke as cs  # noqa: E402
from deep3d_aerial_tpu_torch.ops import cuda_build  # noqa: E402
from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3  # noqa: E402
from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2  # noqa: E402
from deep3d_aerial_tpu_torch.ops.red_step4 import red_step4  # noqa: E402
from deep3d_aerial_tpu_torch.ops.sweep import sweep_corr, sweep_cost, sweep_var  # noqa: E402
from deep3d_aerial_tpu_torch.utils import native  # noqa: E402

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cuda_build.build(); native.build()
dev = torch.device("cuda")
cam0, poses0 = cs.survey(cs.W0, cs.H0)
N = cs.NDEPTHS
# (model, counters, launches per map, eager softmax updates per map, COLMAP
# workspace): as chip_smoke.main runs each main path
cases = [
    ("adamvs", (sweep_corr, sweep_cost, red_step2),
     {"sweep_corr": 1, "sweep_cost": sum(d // 8 for d in N), "red_step2": sum(N)}, 0, False),
    ("msrednet", (sweep_var, red_step4, cf_conv3x3),
     {"sweep_var": sum(d // 8 for d in N), "red_step4": sum(N),
      "cf_conv3x3": cs.RED4_CONVS * sum(N)}, sum(N), False),
    ("casmvsnet", (sweep_var,), {"sweep_var": sum(d // 8 for d in N)}, 0, True),
    ("ucsnet", (sweep_var,), {"sweep_var": sum(d // 8 for d in cs.UCS_NDEPTHS)}, 0, False),
]
# a checkout from before the bfloat16 modes takes no compute_dtype
extra = {"compute_dtype": sys.argv[2]} if len(sys.argv) > 2 else {}
label = " ".join(sys.argv[1:3])
for name, counters, per_map, eager, colmap in cases:
    _, steady, _ = cs.phase_main_path(dev, cam0, poses0, counters, per_map,
                                      model_type=name, eager_updates=eager,
                                      colmap=colmap, **extra)
    print(f"PAIR {label} {name} {1.0 / steady:.3f} maps/s", flush=True)
