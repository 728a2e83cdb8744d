"""Operations and bytes of the plane-sweep kernels K1 (pair), K2 (cost)
and K2v (variance), `csrc/sweep.cu`, from their shapes: V source views, K
planes, H x W pixels, C channels, `fb` bytes a feature and output element.
A frozen copy of chip_smoke.py's sweep_*_work (float32 projection)."""

# projection (3 rays, p = ray*d + t, two divides) + floor/fraction + the
# four bilinear weights, per (plane, pixel, view)
GEOM_FLOPS = 30


def corr(V, K, H, W, C, fb=4):
    """K1: every source view's [K, H, W] correlation volume."""
    nbytes = fb * ((V + 1) * H * W * C + V * K * H * W) + 4 * (K * H * W + 12 * V)
    return nbytes, V * K * H * W * (GEOM_FLOPS + 8 * C + 2 * C)


def cost(V, K, H, W, C, fb=4):
    """K2: the view-weighted correlation cost [K, C, H, W]."""
    nbytes = (fb * ((V + 1) * H * W * C + K * C * H * W)
              + 4 * (K * H * W + V * H * W + 12 * V))
    return nbytes, K * H * W * (V * (GEOM_FLOPS + 11 * C + 1) + C)


def var(V, K, H, W, C, fb=4):
    """K2v: the variance cost [K, C, H, W]."""
    nbytes = fb * ((V + 1) * H * W * C + K * C * H * W) + 4 * (K * H * W + 12 * V)
    return nbytes, K * H * W * (V * (GEOM_FLOPS + 11 * C) + 5 * C)
