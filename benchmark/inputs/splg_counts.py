"""The SuperPoint + LightGlue cells' counts: the networks' operations, for
`splg_mfu` and `lg_attention_roofline`; the published bfloat16 peak of
one NVIDIA H100 SXM; and the class of device kernel names that is
attention. It imports nothing of the port.

The operations are 2 x the multiply-adds of every convolution, linear
layer and matrix product the forward runs (as torch's FlopCounterMode
counts them): SuperPoint's 12 convolutions at a frame's size (the pools
floor each side: 376x1241 -> 47x155 cells); LightGlue's position encoding,
its 9 layers (self block: Wqkv, out_proj, the ffn's two linears; cross
block: to_qk, to_v, to_out, the ffn; attention's q k^T and p v, each
2 N^2 d a head, twice in the self block, once per direction in the cross
block, as the port's flash attention runs them) on both images of a pair,
and the last layer's assignment (final_proj, matchability, the
similarity). Softmaxes, LayerNorm, GELU, NMS, top-k, sampling and the
masks are not counted. `attention_flop`, the roofline's work, is the
least attention needs: the cross block's similarity once (upstream's
non-flash form, one q k^T and two p v), 7 N^2 d multiply-adds a layer
where the flash form runs 8.
"""

from __future__ import annotations

BF16_FLOP_PER_S = 989.4e12  # H100 SXM dense bfloat16 on the tensor cores

# (name, c_in, c_out, kernel size, the pools before it)
SUPERPOINT = (("conv1a", 1, 64, 3, 0), ("conv1b", 64, 64, 3, 0), ("conv2a", 64, 64, 3, 1), ("conv2b", 64, 64, 3, 1),
              ("conv3a", 64, 128, 3, 2), ("conv3b", 128, 128, 3, 2), ("conv4a", 128, 128, 3, 3),
              ("conv4b", 128, 128, 3, 3), ("convPa", 128, 256, 3, 3), ("convPb", 256, 65, 1, 3),
              ("convDa", 128, 256, 3, 3), ("convDb", 256, 256, 1, 3))


def superpoint_flop(height: int, width: int, descriptor_dim: int = 256) -> float:
    """SuperPoint's operations on one height x width frame."""
    macs = 0
    for name, cin, cout, k, pools in SUPERPOINT:
        h, w = height, width
        for _ in range(pools):
            h, w = h // 2, w // 2
        cout = descriptor_dim if name == "convDb" else cout
        macs += cin * cout * k * k * h * w
    return 2.0 * macs


def lightglue_macs(k: int, d: int = 256, layers: int = 9) -> dict:
    """LightGlue's multiply-adds on one pair of k slots each, by kind:
    'linear' (the position encoding, every linear layer, the similarity)
    and 'attention' (q k^T and p v of every layer)."""
    tokens = 2 * k
    self_linear = tokens * (3 * d * d + d * d + 2 * d * 2 * d + 2 * d * d)
    cross_linear = tokens * (3 * d * d + 2 * d * 2 * d + 2 * d * d)
    assign = tokens * (d * d + d) + k * k * d
    posenc = tokens * 2 * (d // 8)  # Wr: 2 -> head_dim / 2 with 4 heads
    attention = layers * 8 * k * k * d  # self: 2 images x (qk + pv); cross: 2 directions x (qk + pv), as run
    return {"linear": posenc + layers * (self_linear + cross_linear) + assign, "attention": attention}


def lightglue_flop(k: int, d: int = 256, layers: int = 9) -> float:
    m = lightglue_macs(k, d, layers)
    return 2.0 * (m["linear"] + m["attention"])


def attention_flop(k: int, d: int = 256, layers: int = 9) -> float:
    """The least operations of LightGlue's attention on one pair of k
    slots: self 2 images x (q k^T + p v), cross one shared q k^T and two
    p v."""
    return 2.0 * layers * 7 * k * k * d


ATTENTION_KEYS = ("flash", "fmha", "sdpa", "attention")  # F.scaled_dot_product_attention's kernels, lower-cased


def is_attention(name: str) -> bool:
    """A kernel of F.scaled_dot_product_attention (flash, memory-efficient
    or cuDNN)."""
    low = name.lower()
    return any(k in low for k in ATTENTION_KEYS)
