"""The kernels' gradient contract on the CPU: ops/autograd.py's KernelFn,
built with launch = the plain version (a CUDA kernel has no CPU mode),
gives gradients bit-equal to plain autograd through every wrapper's plain
version, for every input -- depths included -- and every parameter; the
packed weights of K3 and K4 follow an optimizer step; the streaming sweep
takes the score entry, not the in-place fold, where autograd needs a
gradient; and train()/eval() change nothing in any model."""

import numpy as np
import pytest
import torch

from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.models.cascade import streaming_sweep
from deep3d_aerial_tpu_torch.models.cost_reg import RedStep2, RedStep4
from deep3d_aerial_tpu_torch.ops import red_step2 as rs2
from deep3d_aerial_tpu_torch.ops import red_step4 as rs4
from deep3d_aerial_tpu_torch.ops import sweep
from deep3d_aerial_tpu_torch.ops.autograd import KernelFn, through_kernel
from deep3d_aerial_tpu_torch.ops.cf_conv import cf_conv3x3_plain
from deep3d_aerial_tpu_torch.train.optim import make_optimizer
from deep3d_aerial_tpu_torch.weights import init_random_weights

torch.set_num_threads(1)


def _t(rng, *shape, scale=1.0, grad=True):
    return torch.tensor(rng.normal(scale=scale, size=shape), dtype=torch.float32,
                        requires_grad=grad)


def _rels(rng, V):
    rel = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    rel[:, :3, :3] += rng.normal(scale=0.01, size=(V, 3, 3))
    rel[:, :2, 3] = rng.normal(scale=300.0, size=(V, 2))
    return torch.tensor(rel)


def _sweep_case(kind, rng):
    H, W, C, V, K = 6, 10, 8, 3, 4
    ref, srcs = _t(rng, H, W, C), _t(rng, V, H, W, C)
    depths = torch.tensor(np.sort(rng.uniform(90, 110, (K, H, W)), 0),
                          dtype=torch.float32, requires_grad=True)
    args = [ref, srcs, _rels(rng, V), depths]
    if kind == "cost":
        args.append(torch.tensor(rng.uniform(0.1, 1, (V, H, W)), dtype=torch.float32,
                                 requires_grad=True))
    plain = {"corr": sweep.sweep_corr_plain, "cost": sweep.sweep_cost_plain,
             "var": sweep.sweep_var_plain}[kind]
    return plain, args, None


def _red_case(kind, rng):
    if kind in ("red_step2", "red_step2_up"):
        up = kind == "red_step2_up"
        mod = init_random_weights(RedStep2(8, up=up), seed=5)
        args = [_t(rng, 8, 6, 10), _t(rng, 8, 6, 10, scale=0.5),
                _t(rng, 16, 3, 5, scale=0.5)]
        return (lambda p, *xs: rs2.red_step2_plain(p, *xs, up=up)), args, \
            dict(mod.named_parameters())
    mod = init_random_weights(RedStep4(8), seed=6)
    args = [_t(rng, 8, 8, 16)] + [_t(rng, c, 8 >> l, 16 >> l, scale=0.5)
                                  for l, c in enumerate(rs4.HIDDEN)]
    return rs4.red_step4_plain, args, dict(mod.named_parameters())


def _conv_case(mode, rng):
    ci, co = 8, 16
    w = _t(rng, *((ci, co, 3, 3) if mode == "up" else (co, ci, 3, 3)), scale=0.1)
    args = [_t(rng, ci, 6, 10), w, _t(rng, co, scale=0.1)]
    return (lambda x, w, b: cf_conv3x3_plain(x, w, b, mode=mode)), args, None


CASES = ([("sweep_" + k, _sweep_case, k) for k in ("corr", "cost", "var")]
         + [(k, _red_case, k) for k in ("red_step2", "red_step2_up", "red_step4")]
         + [("cf_conv3x3_" + m, _conv_case, m) for m in ("same", "down", "up")])


@pytest.mark.parametrize("label,case,kind", CASES, ids=[c[0] for c in CASES])
def test_kernel_fn_with_the_plain_forward_is_plain_autograd(label, case, kind):
    rng = np.random.default_rng(7 * len(label) + len(kind))
    plain, args, params = case(kind, rng)
    leaves = list(args) + (list(params.values()) if params else [])
    leaves = [t for t in leaves if t.requires_grad]

    def run(fn):
        outs = fn(params, *args) if params is not None else fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        g = torch.Generator().manual_seed(7)
        proj = sum((o * torch.randn(o.shape, generator=g)).sum() for o in outs)
        return outs, torch.autograd.grad(proj, leaves)

    launches = []

    def launch(*xs):
        launches.append(torch.is_grad_enabled())
        return plain(*xs)

    want_outs, want = run(plain)
    got_outs, got = run(lambda *xs: through_kernel(launch, plain, xs[1:] if params else xs,
                                                   xs[0] if params else None))
    assert launches == [False]        # one launch, under no_grad
    for a, b in zip(got_outs, want_outs):
        assert torch.equal(a, b)
        assert a.grad_fn is not None and "KernelFn" in type(a.grad_fn).__name__
    for leaf, a, b in zip(leaves, got, want):
        assert a is not None and torch.equal(a, b), label
    if kind in ("corr", "cost", "var"):
        assert args[3].requires_grad          # the depths took a gradient


def test_kernel_fn_skips_inputs_that_need_no_gradient():
    rng = np.random.default_rng(3)
    plain, args, _ = _sweep_case("var", rng)
    args[1] = args[1].detach()
    calls = []
    out = KernelFn.apply(lambda xs, ps: calls.append(1) or plain(*xs),
                         lambda xs, ps: plain(*xs), 0, *args)
    gr, gd = torch.autograd.grad(out.sum(), [args[0], args[3]])
    want = torch.autograd.grad(plain(*args).sum(), [args[0], args[3]])
    assert calls == [1] and torch.equal(gr, want[0]) and torch.equal(gd, want[1])
    # without a gradient to take, the launch runs as it is: no Function
    with torch.no_grad():
        assert through_kernel(plain, plain, args).grad_fn is None


@pytest.mark.parametrize("cls,args", [(RedStep2, (8,)), (RedStep4, (8,))])
def test_packed_weights_follow_an_optimizer_step(cls, args):
    """_PackedCache keys on (data_ptr, _version): an optimizer step bumps
    the versions, so the next step packs the new weights; a stale pack
    would run the kernel forward on the old weights while the backward
    differentiates the new ones."""
    mod = init_random_weights(cls(*args), seed=2)
    pack = (lambda p: rs2.pack_params(p, True)) if cls is RedStep2 else \
        (lambda p: rs4.pack_params(p, 8))
    cache = mod._packed
    first = cache.get(mod)
    assert cache.get(mod) is first       # no change, no repack
    opt = make_optimizer(mod.named_parameters(), kind="rmsprop")
    key = cache._key
    opt.step({n: torch.ones_like(p) for n, p in mod.named_parameters()})
    assert tuple((p.data_ptr(), p._version) for p in mod.parameters()) != key
    second = cache.get(mod)
    assert second is not first
    assert torch.equal(second, pack(dict(mod.named_parameters())))
    assert not torch.equal(second, first)


class _FoldingReg:
    """A RedStep2 whose step claims the in-place fold (as K3's does on a
    card) and records how the sweep calls it."""

    def __init__(self):
        self.mod = init_random_weights(RedStep2(8, up=False), seed=3)
        self.calls = []

    def init_states(self, *a, **kw):
        return self.mod.init_states(*a, **kw)

    def plane_step(self, device, dtype=torch.float32):
        def step(cost, s1, s2, osm=None, dv=None):
            self.calls.append(osm is not None)
            return rs2.red_step2(dict(self.mod.named_parameters()), cost, s1, s2,
                                 up=False, osm=osm, dv=dv)
        step.folds_softmax = True
        return step


def test_streaming_sweep_folds_only_without_grad():
    rng = np.random.default_rng(4)
    H, W, C, V = 6, 10, 8, 2
    ref, srcs = _t(rng, H, W, C), _t(rng, V, H, W, C)
    rels = _rels(rng, V)
    depths = torch.linspace(90.0, 110.0, 4)
    reg = _FoldingReg()
    d, _ = streaming_sweep(reg, False, depths, ref, srcs, rels, None, plane_chunk=2)
    assert reg.calls == [False] * 4 and d.grad_fn is not None
    with torch.no_grad():
        d2, _ = streaming_sweep(reg, False, depths, ref, srcs, rels, None, plane_chunk=2)
    assert reg.calls[4:] == [True] * 4
    np.testing.assert_allclose(d.detach().numpy(), d2.numpy(), rtol=0, atol=1e-4)


def test_red_step2_fold_refuses_a_gradient():
    """The fold writes its softmax state in place: where autograd needs a
    gradient the CUDA entry raises instead of silently cutting it."""
    mod = init_random_weights(RedStep2(8, up=False), seed=3)

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    cost = torch.zeros(8, 4, 4).as_subclass(FakeCuda)
    osm = tuple(torch.zeros(4, 4) for _ in range(4))
    with pytest.raises(ValueError, match="in place"):
        rs2.red_step2(dict(mod.named_parameters()), cost, torch.zeros(8, 4, 4),
                      torch.zeros(16, 2, 2), up=False, osm=osm, dv=torch.zeros(4, 4))


@pytest.mark.parametrize("name,kw", [
    ("adamvs", dict(ndepths=(4, 4, 4), num_depth=16, plane_chunk=2)),
    ("msrednet", dict(ndepths=(2, 2, 2), num_depth=16, plane_chunk=2)),
    ("casmvsnet", dict(ndepths=(8, 8, 8), num_depth=16)),
    ("ucsnet", dict(ndepths=(8, 8, 8), num_depth=16)),
])
def test_train_and_eval_modes_compute_the_same(name, kw):
    """No dropout, no batch norm: the mode changes nothing."""
    rng = np.random.default_rng(8)
    model = init_random_weights(build_model(name, **kw), seed=8)
    imgs = torch.tensor(rng.normal(size=(2, 32, 32, 3)), dtype=torch.float32)
    rel = torch.eye(4).repeat(3, 1, 1, 1)
    rel[..., 0, 3] = 3.0
    with torch.no_grad():
        a = model.train()(imgs, rel, 80.0, 120.0)
        b = model.eval()(imgs, rel, 80.0, 120.0)
    assert not any(isinstance(m, (torch.nn.Dropout, torch.nn.modules.batchnorm._BatchNorm))
                   for m in model.modules())
    for key in ("depth", "photometric_confidence"):
        assert torch.equal(a[key], b[key])
