"""Operations and bytes of one convolution, from its shapes."""


def out_hw(H: int, W: int, stride: int):
    return -(-H // stride), -(-W // stride)


def flops(ci: int, co: int, k: int, H: int, W: int, stride: int = 1,
          transposed: bool = False) -> int:
    """2 Ci Co k^2 x output pixels ('SAME', input H x W); a stride-2
    transposed conv counts its taps per input pixel."""
    if transposed:
        return 2 * ci * co * k * k * H * W
    Ho, Wo = out_hw(H, W, stride)
    return 2 * ci * co * k * k * Ho * Wo


def conv3x3_work(ci: int, co: int, H: int, W: int, mode: str, eb: int = 4):
    """One 3x3 conv ('same', 'down' stride 2, 'up' transposed 2x): input,
    output and weights once (`eb` bytes an element; the bias float32);
    multiply-adds x 2. A frozen copy of chip_smoke.py's conv_work."""
    Ho, Wo = {"same": (H, W), "down": ((H + 1) // 2, (W + 1) // 2),
              "up": (2 * H, 2 * W)}[mode]
    macs = ci * co * 9 * (H * W if mode == "up" else Ho * Wo)
    return eb * (ci * H * W + co * Ho * Wo + ci * 9 * co) + 4 * co, 2 * macs
