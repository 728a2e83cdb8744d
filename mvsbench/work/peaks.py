"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the least time of a piece of work against them."""

# float32 on the CUDA cores
FP32 = 67e12
# float32-exact products on the dense TF32 tensor cores: 3xTF32, three
# products a multiply-add, a third of 495 TFLOP/s
TF32X3 = 495e12 / 3
# bfloat16 on the dense tensor cores
BF16 = 989e12
# HBM3
BYTES = 3.35e12


def least_ms(nbytes: float, flops: float, peak: float = FP32) -> float:
    """The least milliseconds: each input byte read once and each output
    byte written once at the memory rate, or the operations at `peak`,
    whichever is longer."""
    return max(nbytes / BYTES, flops / peak) * 1e3
