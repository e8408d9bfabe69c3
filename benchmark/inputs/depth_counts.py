"""The depth cells' counts: MonoDepth2's operations a frame, counted from
its layer list, for `depth_mfu`; the published bfloat16 peak of one NVIDIA
H100 SXM; and the classes of device kernel names the depth metrics sort a
trace into (the classes of tools/profile_torch_depth.py, with cuDNN's
padding and tensor-transform helpers among the layout kernels, and the
depth driver's thumbnail pooling in a class of its own). It imports nothing
of the port.

The operations are 2 x the multiply-adds of every convolution of the
network at its input size, scale-0 head only: ResNet-18 (conv1 7x7 stride
2, four stages of two BasicBlocks, 1x1 projections where the stride or the
width changes) and the depth decoder (two reflection-padded 3x3 convs a
level, the second after the skip concatenation, and the disparity head).
Resize, BatchNorm, activations, padding, pooling and concatenation are not
counted.
"""

from __future__ import annotations

BF16_FLOP_PER_S = 989.4e12  # H100 SXM dense bfloat16 on the tensor cores

ENC_CH = (64, 64, 128, 256, 512)
DEC_CH = (16, 32, 64, 128, 256)
BLOCKS = (2, 2, 2, 2)


def conv_layers(height: int, width: int) -> list:
    """(name, c_in, c_out, kernel, out_h, out_w) of every convolution a
    forward runs at `height` x `width` (multiples of 32)."""
    if height % 32 or width % 32:
        raise ValueError(f"{height}x{width}: the sides must be multiples of 32")
    layers = [("conv1", 3, ENC_CH[0], 7, height // 2, width // 2)]
    c_in = ENC_CH[0]
    for stage, n_blocks in enumerate(BLOCKS, start=1):
        c, scale = ENC_CH[stage], 2 ** (stage + 1)
        h, w = height // scale, width // scale
        for b in range(n_blocks):
            cin = c_in if b == 0 else c
            layers += [(f"layer{stage}.{b}.conv1", cin, c, 3, h, w), (f"layer{stage}.{b}.conv2", c, c, 3, h, w)]
            if b == 0 and cin != c:
                layers.append((f"layer{stage}.{b}.downsample", cin, c, 1, h, w))
        c_in = c
    for i in range(4, -1, -1):
        cin = ENC_CH[-1] if i == 4 else DEC_CH[i + 1]
        layers.append((f"upconv{i}.0", cin, DEC_CH[i], 3, height >> (i + 1), width >> (i + 1)))
        cin = DEC_CH[i] + (ENC_CH[i - 1] if i > 0 else 0)
        layers.append((f"upconv{i}.1", cin, DEC_CH[i], 3, height >> i, width >> i))
    layers.append(("dispconv0", DEC_CH[0], 1, 3, height, width))
    return layers


def flop_per_frame(height: int, width: int) -> float:
    return 2.0 * sum(cin * cout * k * k * h * w for _, cin, cout, k, h, w in conv_layers(height, width))


KINDS = (  # first match wins; kernel names lower-cased
    ("thumbnail", ("avg_pool",)),  # the depth driver's answer; the network has no average pooling
    ("layout", ("nchwtonhwc", "nhwctonchw", "transpose", "addpadding", "tensortransform")),
    ("resize", ("upsample",)),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw")),
    ("pad", ("reflection_pad",)),
    ("max_pool", ("max_pool",)),
    ("cat", ("catarray", "cat_")),
    ("conv", ("conv", "cudnn", "xmma", "gemm", "cutlass", "implicit", "winograd", "fft", "sm90", "sm80")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def is_conv(name: str) -> bool:
    """A convolution or GEMM kernel (cuDNN's, CUTLASS's or cuBLAS's)."""
    return kind_of(name) == "conv"


def is_nonconv(name: str) -> bool:
    """A kernel of the network that is not a convolution or GEMM (not the
    driver's thumbnail either)."""
    return kind_of(name) not in ("conv", "thumbnail")
