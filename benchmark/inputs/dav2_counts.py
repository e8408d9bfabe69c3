"""The Depth Anything V2 cells' counts: the network's operations a frame,
counted from its layer list, for `dav2_mfu` and `dav2_attention_roofline`;
the published bfloat16 peak of one NVIDIA H100 SXM; and the classes of
device kernel names the Depth Anything metrics sort a trace into. It
imports nothing of the port (the resize rule is the plain reference's).

The operations are 2 x the multiply-adds of every linear layer,
convolution and transposed convolution the forward runs, plus attention's
two products (q k^T and p v, 2 N^2 d each a head), at the model's input
size: the patch embedding, the `max(layers) + 1` blocks (qkv, proj, fc1,
fc2, attention), the DPT head's projections, resizes, layer{1-4}_rn, the
fusion blocks' ResidualConvUnits (refinenet4 runs resConfUnit2 only) and
out_convs, and the output convolutions. LayerNorm, GELU, softmax, the
LayerScale and residual adds, ReLU and the interpolations are not counted.
"""

from __future__ import annotations

from benchmark.reference.plaindav2.depth_anything import target_size

BF16_FLOP_PER_S = 989.4e12  # H100 SXM dense bfloat16 on the tensor cores


def grid(height: int, width: int, model: dict) -> tuple:
    """The patch grid (gh, gw) of a height x width frame: upstream's
    lower-bound resize to `input_size`, over the patch."""
    p = model["patch_size"]
    h, w = target_size(height, width, model["input_size"], p)
    return h // p, w // p


def encoder_macs(model: dict, tokens: int) -> dict:
    """Multiply-adds a frame of the encoder at `tokens` tokens (class token
    included), by kind: 'linear' (patch embedding, qkv, proj, fc1, fc2)
    and 'attention' (q k^T and p v)."""
    d, p, n = model["embed_dim"], model["patch_size"], tokens
    blocks = max(model["layers"]) + 1
    hidden = d * model["mlp_ratio"]
    linear = (n - 1) * d * 3 * p * p + blocks * n * (3 * d * d + d * d + 2 * d * hidden)
    return {"linear": linear, "attention": blocks * 2 * n * n * d}


def head_layers(model: dict, gh: int, gw: int) -> list:
    """(name, c_in, c_out, kernel area, output pixels) of every convolution
    and transposed convolution of the DPT head at a gh x gw patch grid; a
    transposed conv's kernel area counts the outputs one input pixel feeds
    (4x4 stride 4, 2x2 stride 2: no overlap), its pixels the inputs."""
    d, f, oc, p = model["embed_dim"], model["features"], model["out_channels"], model["patch_size"]
    g = gh * gw
    half = ((gh - 1) // 2 + 1) * ((gw - 1) // 2 + 1)  # the 3x3 stride-2 conv's output
    sizes = [16 * g, 4 * g, g, half]  # levels 1-4
    layers = [(f"projects.{i}", d, c, 1, g) for i, c in enumerate(oc)]
    layers += [("resize_layers.0", oc[0], oc[0], 16, g), ("resize_layers.1", oc[1], oc[1], 4, g),
               ("resize_layers.3", oc[3], oc[3], 9, half)]
    layers += [(f"layer{i + 1}_rn", c, f, 9, sizes[i]) for i, c in enumerate(oc)]
    for level in (4, 3, 2, 1):
        units = (2,) if level == 4 else (1, 2)
        layers += [(f"refinenet{level}.resConfUnit{u}.conv{c}", f, f, 9, sizes[level - 1])
                   for u in units for c in (1, 2)]
        out = sizes[level - 2] if level > 1 else 4 * sizes[0]  # resized to the next level, or x2
        layers.append((f"refinenet{level}.out_conv", f, f, 1, out))
    full = gh * p * gw * p
    layers += [("output_conv1", f, f // 2, 9, 4 * sizes[0]), ("output_conv2.0", f // 2, 32, 9, full),
               ("output_conv2.2", 32, 1, 1, full)]
    return layers


def head_macs(model: dict, gh: int, gw: int) -> int:
    return sum(cin * cout * k * px for _, cin, cout, k, px in head_layers(model, gh, gw))


def flop_per_frame(model: dict, gh: int, gw: int) -> float:
    enc = encoder_macs(model, 1 + gh * gw)
    return 2.0 * (enc["linear"] + enc["attention"] + head_macs(model, gh, gw))


def attention_flop_per_frame(model: dict, tokens: int) -> float:
    return 2.0 * encoder_macs(model, tokens)["attention"]


KINDS = (  # first match wins; kernel names lower-cased
    ("thumbnail", ("avg_pool",)),  # the driver's answer; the network has no average pooling
    ("layout", ("nchwtonhwc", "nhwctonchw", "addpadding", "tensortransform")),
    ("attention", ("flash", "fmha", "sdpa", "attention")),
    ("matmul", ("gemm", "nvjet", "cublas", "cutlass", "xmma", "conv", "cudnn", "implicit", "winograd", "sm90",
                "sm80")),
    ("layer_norm", ("layer_norm",)),
    ("gelu", ("gelu",)),
    ("resize", ("upsample",)),
    ("cat", ("catarray", "cat_")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"  # elementwise adds, ReLU, casts, copies and the rest


def is_attention(name: str) -> bool:
    """An attention kernel (F.scaled_dot_product_attention's flash,
    memory-efficient or cuDNN kernel)."""
    return kind_of(name) == "attention"


def is_nonmatmul(name: str) -> bool:
    """A kernel of the network that is not a GEMM, a convolution or
    attention (not the driver's thumbnail either)."""
    return kind_of(name) not in ("matmul", "attention", "thumbnail")
