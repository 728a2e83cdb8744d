"""The port's bfloat16 operating point against the JAX package's, block by
block, on the CPU: FeatureNet ('branch', 'fpn'), CostRegNet2D,
CostRegNet3D, the plain bfloat16 versions of K3 (RedStep2) and K4
(RedStep4) against the flax bodies in bfloat16, and the streaming sweep in
its correlation and variance modes; then the settings the port refuses
(compute dtype float16; a kernel's gradient in bfloat16).

The JAX oracle is the package's plain path (flax modules with
dtype=jnp.bfloat16, warp_impl 'xla', red_impl 'flax'), on the weights of
the port's seeded initializer, perturbed, handed to JAX through
weights.state_dict_to_tree (no JAX init to trace); the two frameworks
round to bfloat16 at different places (XLA may keep a fused chain in
float32 where PyTorch rounds each op), so the port cannot match it bit for
bit. Tolerance, for every output: with P the port's bfloat16 output, J the
JAX package's bfloat16 output and F its float32 output on the same inputs
and weights, max|P - J| <= 2 x max|J - F| + 2 bfloat16 ulps of max|J| (one
ulp of M: 2^(floor(log2 M) - 7)): the port's bfloat16 is no further from
JAX's than twice what bfloat16 itself moves JAX's result, plus two
roundings of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
import flax.linen as fnn

from deep3d_aerial_tpu.geometry.camera import proj_matrix, stage_relative_projections
from deep3d_aerial_tpu.models.cascade import streaming_sweep as jstreaming_sweep
from deep3d_aerial_tpu.models.cost_reg import CostRegNet2D as JCostRegNet2D
from deep3d_aerial_tpu.models.cost_reg import CostRegNet3D as JCostRegNet3D
from deep3d_aerial_tpu.models.cost_reg import RedStep2 as JRedStep2
from deep3d_aerial_tpu.models.cost_reg import RedStep4 as JRedStep4
from deep3d_aerial_tpu.models.feature_net import FeatureNet as JFeatureNet
from deep3d_aerial_tpu.ops.pallas_red import red_step2_reference
from deep3d_aerial_tpu.ops.pallas_red4 import red_step4_reference
from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.models.cascade import streaming_sweep
from deep3d_aerial_tpu_torch.models.cost_reg import (
    CostRegNet2D,
    CostRegNet3D,
    RedStep2,
    RedStep4,
)
from deep3d_aerial_tpu_torch.models.feature_net import FeatureNet
from deep3d_aerial_tpu_torch.ops.autograd import through_kernel
from deep3d_aerial_tpu_torch.ops.red_step2 import red_step2_plain
from deep3d_aerial_tpu_torch.ops.red_step4 import red_step4_plain
from deep3d_aerial_tpu_torch.pipeline.config import PipelineConfig
from deep3d_aerial_tpu_torch.pipeline.orchestrator import AerialPipeline
from deep3d_aerial_tpu_torch.weights import (
    init_random_weights,
    load_jax_weights,
    state_dict_to_tree,
)
from tests.conftest import random_pose, toy_camera
from tests.test_torch_models import nchw
from tests.test_torch_train_step import nest

torch.set_num_threads(1)
BF = torch.bfloat16
JBF = jnp.bfloat16


def bf16_ulps(top, n=2):
    """n bfloat16 ulps of the magnitude `top` (one ulp of M:
    2^(floor(log2 M) - 7))."""
    return n * 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def check_bf16(port, jbf, jf32, what="", floor_ulps=2):
    """max|port - jbf| <= 2 max|jbf - jf32| + floor_ulps bf16 ulps of
    max|jbf| (the module docstring's rule)."""
    p, j, f = (np.asarray(x, np.float32) for x in (port, jbf, jf32))
    assert p.shape == j.shape == f.shape, (what, p.shape, j.shape)
    gap = float(np.abs(j - f).max())
    floor = bf16_ulps(float(np.abs(j).max()), floor_ulps)
    diff = float(np.abs(p - j).max())
    assert np.isfinite(p).all(), what
    assert diff <= 2 * gap + floor, (
        f"{what}: port vs JAX bf16 {diff:.4g} > 2 x JAX's bf16-vs-f32 gap "
        f"{gap:.4g} + {floor_ulps} ulps {floor:.4g}")


def seeded(tmod, rng, scale=0.05):
    """The port module `tmod`'s seeded initial weights with every leaf
    perturbed (non-zero biases and norm offsets), loaded into `tmod` and
    returned as the tree the flax module applies (no JAX init to trace)."""
    tree = state_dict_to_tree(init_random_weights(tmod, seed=7))
    flat = {k: (v + rng.normal(scale=scale, size=v.shape)).astype(np.float32)
            for k, v in tree.items()}
    load_jax_weights(tmod, flat)
    return nest(flat)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0)))[None]


@pytest.mark.parametrize("arch", ["branch", "fpn"])
def test_feature_net_bf16(arch):
    rng = np.random.default_rng(1001)
    H, W = 32, 48
    img = rng.normal(size=(H, W, 3)).astype(np.float32)
    j32, jbf = JFeatureNet(arch=arch), JFeatureNet(arch=arch, dtype=JBF)
    tmod = FeatureNet(arch=arch)
    jp = seeded(tmod, rng)
    want32 = jax.jit(j32.apply)(jp, jnp.asarray(img))
    wantbf = jax.jit(jbf.apply)(jp, jnp.asarray(img))
    with torch.no_grad():
        got = tmod(nchw(img[None]).to(BF))
    for s, (g, jb, jf) in enumerate(zip(got, wantbf, want32)):
        assert g.dtype == BF
        check_bf16(g[0].float().numpy(), np.moveaxis(np.asarray(jb, np.float32), -1, 0),
                   np.moveaxis(np.asarray(jf), -1, 0), f"{arch} stage {s + 1}")


def test_cost_reg_net_2d_bf16():
    rng = np.random.default_rng(1002)
    H, W, D = 16, 24, 16
    x = rng.normal(size=(H, W, D)).astype(np.float32)
    j32, jbf = JCostRegNet2D(), JCostRegNet2D(dtype=JBF)
    tmod = CostRegNet2D(D)
    jp = seeded(tmod, rng)
    with torch.no_grad():
        got = tmod(nchw(x[None]).to(BF))[0]
    assert got.dtype == BF
    check_bf16(got.float().numpy(),
               np.moveaxis(np.asarray(jax.jit(jbf.apply)(jp, jnp.asarray(x)), np.float32), -1, 0),
               np.moveaxis(np.asarray(jax.jit(j32.apply)(jp, jnp.asarray(x))), -1, 0),
               "CostRegNet2D")


def test_cost_reg_net_3d_bf16():
    rng = np.random.default_rng(1003)
    C = 8
    vol = rng.normal(size=(8, 16, 16, C)).astype(np.float32)
    j32, jbf = JCostRegNet3D(), JCostRegNet3D(dtype=JBF)
    tmod = CostRegNet3D(C)
    jp = seeded(tmod, rng)
    with torch.no_grad():
        got = tmod(ncdhw(vol).to(BF))[0, 0]
    assert got.dtype == BF
    check_bf16(got.float().numpy(),
               np.asarray(jax.jit(jbf.apply)(jp, jnp.asarray(vol)), np.float32),
               np.asarray(jax.jit(j32.apply)(jp, jnp.asarray(vol))), "CostRegNet3D")


@pytest.mark.parametrize("up", [True, False])
def test_red_step2_plain_bf16(up):
    """K3's plain bfloat16 version (the kernel's rounding points) against
    the flax RedStep2 body in bfloat16, one step."""
    rng = np.random.default_rng(1004 + up)
    cin, H, W = 16, 12, 16
    cost = rng.normal(size=(H, W, cin)).astype(np.float32)
    s1 = rng.normal(scale=0.5, size=(8, H, W)).astype(np.float32)
    s2 = rng.normal(scale=0.5, size=(16, H // 2, W // 2)).astype(np.float32)
    tmod = RedStep2(cin, up=up)
    jp = seeded(tmod, rng, 0.1)
    ref = jax.jit(red_step2_reference, static_argnames=("up", "dtype"))
    args = (jnp.asarray(cost), jnp.asarray(s1), jnp.asarray(s2))
    want32 = ref(jp["params"], *args, up=up, dtype=jnp.float32)
    wantbf = ref(jp["params"], *args, up=up, dtype=JBF)
    with torch.no_grad():
        got = red_step2_plain(dict(tmod.named_parameters()),
                              t(np.moveaxis(cost, -1, 0)).to(BF), t(s1).to(BF),
                              t(s2).to(BF), up=up)
    for name, g, jb, jf in zip(("score", "s1", "s2"), got, wantbf, want32):
        assert g.dtype == BF
        check_bf16(g.float().numpy(), jb, jf, f"RedStep2 {name}")


def test_red_step4_plain_bf16():
    """K4's plain bfloat16 version against the flax RedStep4 body in
    bfloat16, two chained planes."""
    rng = np.random.default_rng(1006)
    cin, H, W = 8, 16, 16
    costs = [rng.normal(size=(H, W, cin)).astype(np.float32) for _ in range(2)]
    states = [rng.normal(scale=0.5, size=(c, H >> l, W >> l)).astype(np.float32)
              for l, c in enumerate((8, 16, 32, 64))]
    tmod = RedStep4(cin)
    jp = seeded(tmod, rng, 0.1)
    ref = jax.jit(red_step4_reference, static_argnames=("dtype",))
    params_t = dict(tmod.named_parameters())
    want = {}
    for dt in (jnp.float32, JBF):
        ss = [jnp.asarray(s) for s in states]
        for c in costs:
            out = ref(jp["params"], jnp.asarray(c), *ss, dtype=dt)
            ss = list(out[1:])
        want[dt] = out
    ss = [t(s).to(BF) for s in states]
    with torch.no_grad():
        for c in costs:
            got = red_step4_plain(params_t, t(np.moveaxis(c, -1, 0)).to(BF), *ss)
            ss = list(got[1:])
    for i, (g, jb, jf) in enumerate(zip(got, want[JBF], want[jnp.float32])):
        assert g.dtype == BF
        check_bf16(g.float().numpy(), jb, jf, f"RedStep4 output {i}")


class _JSweep(fnn.Module):
    mode: str
    up: bool
    dtype: object

    @fnn.compact
    def __call__(self, depths, ref, srcs, rels, weights):
        if self.mode == "variance":
            reg = JRedStep4(dtype=self.dtype, name="red0")
            weights = None
        else:
            reg = JRedStep2(up=self.up, dtype=self.dtype, name="red0")
        return jstreaming_sweep(
            reg=reg, cost_mode=self.mode, up=self.up, depths=depths,
            ref_feat=ref.astype(self.dtype), src_feats=srcs.astype(self.dtype),
            rel_projs=rels, weights=weights, plane_chunk=2)


@pytest.mark.parametrize("mode,up,C", [("correlation", True, 16),
                                       ("variance", False, 8)])
def test_streaming_sweep_bf16(mode, up, C):
    """Four chunks of 2 planes of the streaming sweep (K2 + K3, or K2v +
    K4) with bfloat16 features, costs and states; depth and confidence
    come out float32."""
    rng = np.random.default_rng(1007 + up)
    H, W, V = 16, 16, 3
    cam = toy_camera(width=W, height=H, f=1.2 * W)
    projs = np.stack([proj_matrix(cam.K, random_pose(rng)) for _ in range(V + 1)])
    rels = stage_relative_projections(projs, 1)[0].astype(np.float32)
    ref = rng.normal(size=(H, W, C)).astype(np.float32)
    srcs = rng.normal(size=(V, H, W, C)).astype(np.float32)
    depths = np.sort(rng.uniform(85, 115, size=(8, H, W)), 0).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, size=(V, H, W)).astype(np.float32)
    args = (depths, ref, srcs, rels, weights)
    jargs = tuple(map(jnp.asarray, args))
    holder = tnn.Module()
    holder.red0 = RedStep2(C, up=up) if mode == "correlation" else RedStep4(C)
    jp = seeded(holder, rng, 0.2)
    want32 = jax.jit(_JSweep(mode=mode, up=up, dtype=jnp.float32).apply)(jp, *jargs)
    wantbf = jax.jit(_JSweep(mode=mode, up=up, dtype=JBF).apply)(jp, *jargs)
    with torch.no_grad():
        got = streaming_sweep(holder.red0, up, t(depths), t(ref).to(BF), t(srcs).to(BF),
                              t(rels), t(weights) if mode == "correlation" else None,
                              plane_chunk=2, cost_mode=mode)
    for name, g, jb, jf in zip(("depth", "confidence"), got, wantbf, want32):
        assert g.dtype == torch.float32
        check_bf16(g.numpy(), jb, jf, f"{mode} sweep {name}")


def test_compute_dtype_float16_is_refused(tmp_path):
    """Only float32 and bfloat16 run: the config and the models raise
    ValueError naming both, before any work."""
    cfg = PipelineConfig(model_type="adamvs", compute_dtype="float16",
                         allow_random_weights=True)
    pipe = AerialPipeline(str(tmp_path), cfg, device="cpu")
    for fn in (pipe.dense_match, pipe.build_model):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn()
    for name in ("adamvs", "msrednet", "casmvsnet", "ucsnet"):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            build_model(name, dtype=torch.float16)
    assert build_model("adamvs", dtype="bfloat16").dtype == BF


def test_kernel_function_refuses_bf16_under_grad():
    """A kernel's gradient in bfloat16 is on no JAX entry point: the
    Function raises NotImplementedError; without grad the launch runs."""
    x = torch.ones(4, dtype=BF, requires_grad=True)
    calls = []

    def launch(a):
        calls.append(a.dtype)
        return a * 2

    with pytest.raises(NotImplementedError, match="bfloat16"):
        through_kernel(launch, lambda a: a * 2, (x,))
    assert calls == []
    with torch.no_grad():
        out = through_kernel(launch, lambda a: a * 2, (x,))
    assert calls == [BF] and out.dtype == BF
    # float32 under grad still goes through the Function
    y = torch.ones(4, requires_grad=True)
    through_kernel(launch, lambda a: a * 2, (y,)).sum().backward()
    assert torch.equal(y.grad, torch.full((4,), 2.0))
