"""Operations and bytes of one RedStep4 step, kernel K4 with its conv
template K5 (`csrc/red_step4.cu`), from its shapes: cost [Cin, H, W], the
states 8/16/32/64 at H>>l x W>>l. A frozen copy of chip_smoke.py's
red_step4_convs and red_step4_work."""

from .conv import conv3x3_work


def convs(cin, H, W):
    """The 15 convolutions of a step: (name, Ci, Co, input H, input W, mode)."""
    h, w = [H >> l for l in range(4)], [W >> l for l in range(4)]
    return [("conv1", cin, 16, h[0], w[0], "down"),
            ("conv2", 16, 32, h[1], w[1], "down"),
            ("conv3", 32, 64, h[2], w[2], "down"),
            ("gates1", cin + 8, 16, h[0], w[0], "same"),
            ("gates2", 32, 32, h[1], w[1], "same"),
            ("gates3", 64, 64, h[2], w[2], "same"),
            ("gates4", 128, 128, h[3], w[3], "same"),
            ("cand1", cin + 8, 8, h[0], w[0], "same"),
            ("cand2", 32, 16, h[1], w[1], "same"),
            ("cand3", 64, 32, h[2], w[2], "same"),
            ("cand4", 128, 64, h[3], w[3], "same"),
            ("upconv3", 64, 32, h[3], w[3], "up"),
            ("upconv2", 32, 16, h[2], w[2], "up"),
            ("upconv1", 16, 8, h[1], w[1], "up"),
            ("score", 8, 1, h[0], w[0], "same")]


def step(cin, H, W, n_weights, eb=4):
    """The 15 convs' multiply-adds x 2 (GroupNorm and GRU pointwise math
    ~1%, left out); bytes: cost and the four states in, the states and
    the score out, and the weights."""
    flops = sum(conv3x3_work(*c[1:])[1] for c in convs(cin, H, W))
    states = sum(c * (H >> l) * (W >> l) for l, c in enumerate((8, 16, 32, 64)))
    return eb * (cin * H * W + 2 * states + H * W + n_weights), flops
