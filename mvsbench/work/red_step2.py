"""Operations and bytes of one RedStep2 step, kernel K3 (`csrc/red_step2.cu`),
from its shapes: cost [Cin, H, W], the GRU widths 8 and 16, the score at
2H x 2W when `up`. A frozen copy of chip_smoke.py's red_step2_work."""


def step(cin, H, W, up, n_weights, fold=False, eb=4):
    """Convolution multiply-adds x 2 (the pointwise GRU and softmax math is
    ~1% and left out); bytes (`eb` an element): cost and both states in,
    states out, the weights, and the score out, or with `fold` the float32
    online-softmax state (4 maps) in and out and the plane's depth in, at
    the score's shape."""
    H2, W2 = (H + 1) // 2, (W + 1) // 2
    macs = (H * W * 9 * (cin * 8 + 16 * 16 + 16 * 8)
            + H2 * W2 * 9 * (8 * 16 + 32 * 32 + 32 * 16 + 16 * 8)
            + H * W * 9 * 8)
    score = 4 * H * W if up else H * W
    nbytes = (eb * (cin * H * W + 2 * 8 * H * W + 2 * 16 * H2 * W2 + n_weights)
              + (4 * 9 * score if fold else eb * score))
    return nbytes, 2 * macs
