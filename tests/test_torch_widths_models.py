"""Whole forwards at the widths and norms that the JAX models accept beyond
their published settings, against the JAX package's, on the CPU:
AdaMVS(base_channels=16) (cost widths 64/32/16 into base-8 RedStep2s),
AdaMVS(base_channels=3) (an odd width: 12/6/3),
MSREDNet(base_channels=16) (64/32/16 into base-8 RedStep4s),
CasMVSNet(base_channels=4), UCSNet(norm='layer') and CasMVSNet(norm='batch')
(with non-trivial BatchNorm statistics), on 3 views of a tiny frame with
few planes. JAX's recurrent sweeps run one plane a scan step (plane_chunk
1: the same planes in the same order, the fewest operations to trace).

The JAX oracle is the package's plain path (warp_impl 'xla', red_impl
'flax') on the port's seeded initializer's weights, perturbed, handed to
JAX through weights.state_dict_to_tree (with the 'batch_stats'
collection for BatchNorm). Tolerance, per stage: depth within 1e-3 x the
depth range, confidence within 1e-4, as the published widths' forwards in
tests/test_torch_models.py and the others.

norm='batch' in the JAX models: every nn.vmap of the JAX package (the
feature nets over views, the pair hourglass, CostRegNet3D over depth
blocks) maps the 'params' collection only, so every JAX model built with
norm='batch' raises ScopeCollectionNotFound in init and apply
(`test_jax_models_raise_with_batch_norm`; ROADMAP C.15, a fault of the
reference). The port runs the configuration, and its oracle here is the
JAX model with those vmaps also mapping 'batch_stats' (broadcast, as
'params'): `flax.linen.vmap` patched for the test alone, the JAX package
unchanged.
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep3d_aerial_tpu.models import build_model as jbuild_model
from deep3d_aerial_tpu_torch.models import build_model
from deep3d_aerial_tpu_torch.models.blocks import BatchNorm
from deep3d_aerial_tpu_torch.weights import (
    init_random_weights,
    load_jax_weights,
    state_dict_to_tree,
)
from tests.test_torch_bf16_models import _inputs
from tests.test_torch_models import DMAX, DMIN
from tests.test_torch_train_step import nest

torch.set_num_threads(1)

CASES = {
    "adamvs_base16": ("adamvs", {"base_channels": 16}, (48, 64)),
    # an odd base: the stage-3 branch heads see b + 2 (b // 2) channels
    "adamvs_base3": ("adamvs", {"base_channels": 3}, (48, 64)),
    "msrednet_base16": ("msrednet", {"base_channels": 16}, (64, 64)),
    "casmvsnet_base4": ("casmvsnet", {"base_channels": 4}, (64, 64)),
    "ucsnet_layer": ("ucsnet", {"norm": "layer"}, (64, 64)),
    "casmvsnet_batch": ("casmvsnet", {"norm": "batch"}, (64, 64)),
}
ND = (8, 8, 4)


@pytest.fixture
def vmap_batch_stats(monkeypatch):
    """nn.vmap mapping the 'batch_stats' collection as it maps 'params'."""
    real = fnn.vmap

    def vmap(target, *args, variable_axes=None, **kw):
        axes = dict(variable_axes or {})
        axes.setdefault("batch_stats", None)
        return real(target, *args, variable_axes=axes, **kw)

    monkeypatch.setattr(fnn, "vmap", vmap)


@pytest.mark.parametrize("name", ["adamvs", "casmvsnet", "msrednet", "ucsnet"])
def test_jax_models_raise_with_batch_norm(name):
    """The reference fault: the JAX models' vmaps drop 'batch_stats'; the
    port's forward at the same setting gives finite maps."""
    rng, imgs, rel = _inputs(40, 3, 32, 32)
    extra = {"red_impl": "flax", "plane_chunk": 1} if name in ("adamvs", "msrednet") else {}
    jmod = jbuild_model(name, ndepths=(4, 4, 4), num_depth=64, warp_impl="xla",
                        norm="batch", **extra)
    args = (jnp.asarray(imgs), jnp.asarray(rel), DMIN, DMAX)
    with pytest.raises(flax.errors.ScopeCollectionNotFound, match="batch_stats"):
        jax.jit(jmod.init)(jax.random.PRNGKey(0), *args)
    tmod = init_random_weights(build_model(name, ndepths=(4, 4, 4), num_depth=64,
                                           norm="batch"), seed=1).eval()
    with torch.no_grad():
        out = tmod(torch.from_numpy(imgs), torch.from_numpy(rel), DMIN, DMAX)
    assert torch.isfinite(out["depth"]).all() and out["depth"].shape == (32, 32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, request):
    name, kw, (H, W) = CASES[case]
    if kw.get("norm") == "batch":
        request.getfixturevalue("vmap_batch_stats")
    rng, imgs, rel = _inputs(500 + len(case), 3, H, W)
    tmod = init_random_weights(build_model(name, ndepths=ND, num_depth=64, **kw), seed=6)
    tree = {k: (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32)
            for k, v in state_dict_to_tree(tmod).items()}
    for k in tree:  # BatchNorm statistics away from (0, 1)
        if k.startswith("['batch_stats']"):
            tree[k] = (rng.normal(scale=0.3, size=tree[k].shape) if k.endswith("['mean']")
                       else rng.uniform(0.5, 2.0, size=tree[k].shape)).astype(np.float32)
    load_jax_weights(tmod, tree).eval()
    if kw.get("norm") == "batch":
        assert any(isinstance(m, BatchNorm) for m in tmod.modules())
        assert any(k.startswith("['batch_stats']") for k in tree)
    extra = {"red_impl": "flax", "plane_chunk": 1} if name in ("adamvs", "msrednet") else {}
    jmod = jbuild_model(name, ndepths=ND, num_depth=64, warp_impl="xla", **kw, **extra)
    args = (jnp.asarray(imgs), jnp.asarray(rel), DMIN, DMAX)
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jmod.apply)(nest(tree), *args))
    with torch.no_grad():
        tout = tmod(torch.from_numpy(imgs), torch.from_numpy(rel), DMIN, DMAX)
    for s in ("stage1", "stage2", "stage3"):
        np.testing.assert_allclose(tout[s]["depth"].numpy(), jout[s]["depth"], rtol=0,
                                   atol=1e-3 * (DMAX - DMIN), err_msg=f"{case} {s}")
        np.testing.assert_allclose(tout[s]["photometric_confidence"].numpy(),
                                   jout[s]["photometric_confidence"], rtol=0, atol=1e-4,
                                   err_msg=f"{case} {s}")
    assert tout["depth"].shape == (H, W)
