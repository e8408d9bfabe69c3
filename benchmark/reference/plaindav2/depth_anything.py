"""A plain PyTorch Depth Anything V2 (Yang et al., "Depth Anything V2",
NeurIPS 2024, arXiv:2406.09414; github.com/DepthAnything/Depth-Anything-V2),
model `depth_anything_v2_vitl`: the reference that slamtpu_torch's
DepthAnythingV2 is held to, by the Depth Anything cells' check and by
tests/test_torch_depth_anything.py.

Written from upstream's description, in functional torch and float32 with
TF32 off (both switches are set to False at import and before every call):

  * Input (depth_anything_v2/dpt.py::image2tensor): RGB / 255, resized to
    the lower bound of `input_size` on both sides with the aspect kept and
    each side a multiple of 14 (util/transform.py::Resize, 'lower_bound'),
    then normalised with ImageNet's mean and standard deviation.
  * Encoder (dinov2.py, vit_large: DINOv2 ViT-L/14, Oquab et al.,
    arXiv:2304.07193): a 14x14 stride-14 patch convolution; a class token;
    the 37x37 position table interpolated bicubically to the patch grid by
    scale factors ((gh + 0.1) / 37, (gw + 0.1) / 37), no antialiasing
    (`interpolate_offset=0.1`); 24 pre-LN blocks x += ls1 * Attn(LN(x)),
    x += ls2 * MLP(LN(x)), LayerNorm eps 1e-6, 16 heads of 64 with biased
    qkv and proj and q scaled by 1/8, MLP 1024 -> 4096 -> 1024 with exact
    GELU; the outputs of blocks [4, 11, 17, 23] through the final
    LayerNorm, class token dropped (`get_intermediate_layers`,
    `use_clstoken=False`).
  * DPT head (dpt.py::DPTHead, util/blocks.py): 1x1 projections to
    [256, 512, 1024, 1024]; resizes by a 4x4 stride-4 transposed conv, a
    2x2 stride-2 transposed conv, identity and a 3x3 stride-2 conv;
    layer{1-4}_rn 3x3 convs to 256 without bias; four FeatureFusionBlocks
    (ResidualConvUnit = ReLU, 3x3, ReLU, 3x3, plus the input; the skip
    through resConfUnit1 added to the path, then resConfUnit2, a bilinear
    resize with align_corners=True to the next level's size or x2, a 1x1
    out_conv; refinenet4 takes one input); output_conv1 (3x3, 256 -> 128),
    a bilinear resize to the input's size (align_corners=True), a 3x3 conv
    to 32, ReLU, a 1x1 conv to 1, ReLU, and the model's final ReLU: the
    relative inverse depth.

Attention is written out as softmax((q / 8) k^T) v, in blocks of heads so
that the [frames, heads, N, N] scores stay under ATTENTION_BUDGET elements
at 4,515 tokens; `PlainDepthAnythingV2.predict_raw` runs the network in
blocks of `frame_block` frames.

It reads state dicts in upstream's checkpoint layout (`pretrained.*`,
`depth_head.*`). It imports torch and numpy only.

Departures from upstream:
  * The resize is bicubic by F.interpolate (half-pixel centres, a = -0.75,
    borders clamped); upstream's cv2 INTER_CUBIC reflects at the border
    instead, so the two differ in the outermost two pixels.
  * The frames are grayscale, repeated to RGB before the resize.
  * The output stays at the model's size (upstream's infer_image resizes
    it back to the frame's).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["PlainDepthAnythingV2", "VITL", "target_size", "preprocess", "pos_embed", "encoder", "head",
           "state_dict_shapes", "draw_state_dict"]

# depth_anything_v2_vitl: model_configs['vitl'] and dinov2.py::vit_large.
VITL = dict(embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4, patch_size=14, img_size=518,
            layers=(4, 11, 17, 23), features=256, out_channels=(256, 512, 1024, 1024))
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6
POS_OFFSET = 0.1  # DINOv2's interpolate_offset
ATTENTION_BUDGET = 2**28  # elements of the float32 score block (1 GiB)


def _tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_tf32_off()


def target_size(height: int, width: int, input_size: int = 518, multiple: int = 14) -> tuple:
    """The model's input size for a height x width frame: upstream's
    Resize(input_size, input_size, keep_aspect_ratio=True,
    ensure_multiple_of=multiple, resize_method='lower_bound')."""
    scale = max(input_size / height, input_size / width)

    def side(x):
        y = int(np.round(x / multiple) * multiple)
        return y if y >= input_size else int(np.ceil(x / multiple) * multiple)

    return side(scale * height), side(scale * width)


def preprocess(frames: torch.Tensor, size: tuple) -> torch.Tensor:
    """[B, H, W] grayscale in [0, 255] (any dtype) -> [B, 3, *size] float32,
    normalised."""
    x = frames.to(torch.float32)[:, None].expand(-1, 3, -1, -1) / 255.0
    if tuple(x.shape[-2:]) != tuple(size):
        x = F.interpolate(x, size=size, mode="bicubic", align_corners=False)
    mean = torch.tensor(MEAN, dtype=x.dtype, device=x.device)[:, None, None]
    std = torch.tensor(STD, dtype=x.dtype, device=x.device)[:, None, None]
    return (x - mean) / std


def pos_embed(table: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """[1, 1 + G^2, D] position table -> [1, 1 + gh gw, D] at a gh x gw
    patch grid (DINOv2's interpolate_pos_encoding)."""
    n = table.shape[1] - 1
    g = int(math.sqrt(n))
    if gh * gw == n and gh == gw:
        return table
    grid = table[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + POS_OFFSET) / g, (gw + POS_OFFSET) / g), mode="bicubic",
                         antialias=False)
    assert tuple(grid.shape[-2:]) == (gh, gw), grid.shape
    return torch.cat([table[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


def _ln(x, sd, p):
    return F.layer_norm(x, x.shape[-1:], sd[p + "weight"], sd[p + "bias"], eps=LN_EPS)


def _attention(x, sd, p, heads):
    b, n, c = x.shape
    qkv = F.linear(x, sd[p + "qkv.weight"], sd[p + "qkv.bias"]).reshape(b, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)  # [B, heads, N, d] each
    q = q * (c // heads) ** -0.5
    step = max(1, ATTENTION_BUDGET // (b * n * n))
    out = torch.empty_like(q)
    for h in range(0, heads, step):
        scores = torch.matmul(q[:, h : h + step], k[:, h : h + step].transpose(-2, -1))
        out[:, h : h + step] = torch.matmul(scores.softmax(dim=-1), v[:, h : h + step])
    return F.linear(out.transpose(1, 2).reshape(b, n, c), sd[p + "proj.weight"], sd[p + "proj.bias"])


def _block(x, sd, p, heads):
    x = x + sd[p + "ls1.gamma"] * _attention(_ln(x, sd, p + "norm1."), sd, p + "attn.", heads)
    h = F.gelu(F.linear(_ln(x, sd, p + "norm2."), sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"]))
    return x + sd[p + "ls2.gamma"] * F.linear(h, sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"])


def encoder(x, sd, arch=VITL) -> tuple:
    """[B, 3, H, W] normalised -> (the patch tokens of the layers `arch`
    names, each [B, gh gw, D] after the final LayerNorm; gh; gw)."""
    ps = arch["patch_size"]
    gh, gw = x.shape[-2] // ps, x.shape[-1] // ps
    p = "pretrained."
    t = F.conv2d(x, sd[p + "patch_embed.proj.weight"], sd[p + "patch_embed.proj.bias"], stride=ps)
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([sd[p + "cls_token"].expand(t.shape[0], -1, -1), t], dim=1)
    t = t + pos_embed(sd[p + "pos_embed"], gh, gw)
    out = []
    for i in range(max(arch["layers"]) + 1):
        t = _block(t, sd, f"{p}blocks.{i}.", arch["num_heads"])
        if i in arch["layers"]:
            out.append(_ln(t, sd, p + "norm.")[:, 1:])
    return out, gh, gw


def _conv(x, sd, p, **kw):
    return F.conv2d(x, sd[p + "weight"], sd.get(p + "bias"), **kw)


def _rcu(x, sd, p):
    out = _conv(F.relu(x), sd, p + "conv1.", padding=1)
    return _conv(F.relu(out), sd, p + "conv2.", padding=1) + x


def _fusion(sd, p, path, skip=None, size=None):
    if skip is not None:
        path = path + _rcu(skip, sd, p + "resConfUnit1.")
    path = _rcu(path, sd, p + "resConfUnit2.")
    path = F.interpolate(path, **({"size": size} if size else {"scale_factor": 2}), mode="bilinear",
                         align_corners=True)
    return _conv(path, sd, p + "out_conv.")


def head(features, gh, gw, sd, patch_size=14) -> torch.Tensor:
    """The DPT head: four [B, gh gw, D] token maps -> [B, gh p, gw p]
    relative inverse depth (the model's final ReLU included)."""
    p = "depth_head."
    layers = []
    for i, t in enumerate(features):
        x = t.transpose(1, 2).reshape(t.shape[0], t.shape[-1], gh, gw)
        x = _conv(x, sd, f"{p}projects.{i}.")
        if i < 2:
            x = F.conv_transpose2d(x, sd[f"{p}resize_layers.{i}.weight"], sd[f"{p}resize_layers.{i}.bias"],
                                   stride=4 // (i + 1))
        elif i == 3:
            x = _conv(x, sd, f"{p}resize_layers.3.", stride=2, padding=1)
        layers.append(_conv(x, sd, f"{p}scratch.layer{i + 1}_rn.", padding=1))
    s = p + "scratch."
    path = _fusion(sd, s + "refinenet4.", layers[3], size=layers[2].shape[-2:])
    path = _fusion(sd, s + "refinenet3.", path, layers[2], size=layers[1].shape[-2:])
    path = _fusion(sd, s + "refinenet2.", path, layers[1], size=layers[0].shape[-2:])
    path = _fusion(sd, s + "refinenet1.", path, layers[0])
    out = _conv(path, sd, s + "output_conv1.", padding=1)
    out = F.interpolate(out, size=(gh * patch_size, gw * patch_size), mode="bilinear", align_corners=True)
    out = F.relu(_conv(out, sd, s + "output_conv2.0.", padding=1))
    out = F.relu(_conv(out, sd, s + "output_conv2.2."))
    return F.relu(out)[:, 0]


class PlainDepthAnythingV2:
    """The reference predictor on `device`, from a state dict in upstream's
    layout (tensors of any floating dtype; held here as float32)."""

    def __init__(self, state_dict: dict, arch: dict = VITL, input_size: int = 518, device="cpu",
                 frame_block: int = 4):
        self.arch, self.input_size, self.device, self.frame_block = arch, input_size, torch.device(device), \
            frame_block
        self.sd = {k: v.to(self.device, torch.float32) for k, v in state_dict.items()}

    def size_of(self, height: int, width: int) -> tuple:
        return target_size(height, width, self.input_size, self.arch["patch_size"])

    @torch.no_grad()
    def predict_raw(self, frames) -> torch.Tensor:
        """[B, H, W] grayscale frames (host or device) -> [B, H', W'] float32
        inverse depth on the device at the model's size."""
        _tf32_off()
        frames = torch.as_tensor(frames)
        size = self.size_of(*frames.shape[-2:])
        out = []
        for i in range(0, len(frames), self.frame_block):
            x = preprocess(frames[i : i + self.frame_block].to(self.device), size)
            features, gh, gw = encoder(x, self.sd, self.arch)
            out.append(head(features, gh, gw, self.sd, self.arch["patch_size"]))
        return torch.cat(out)


def state_dict_shapes(arch: dict = VITL) -> dict:
    """key -> shape of every tensor of upstream's checkpoint for `arch`
    (dinov2.py with block_chunks=0 and no register tokens; dpt.py's head
    with use_bn=False and use_clstoken=False, refinenet4's unused
    resConfUnit1 included)."""
    d, ps, g = arch["embed_dim"], arch["patch_size"], arch["img_size"] // arch["patch_size"]
    hidden, f, oc = d * arch["mlp_ratio"], arch["features"], arch["out_channels"]
    p = "pretrained."
    shapes = {p + "cls_token": (1, 1, d), p + "pos_embed": (1, 1 + g * g, d), p + "mask_token": (1, d),
              p + "patch_embed.proj.weight": (d, 3, ps, ps), p + "patch_embed.proj.bias": (d,)}
    for i in range(arch["depth"]):
        b = f"{p}blocks.{i}."
        shapes.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                       b + "attn.qkv.weight": (3 * d, d), b + "attn.qkv.bias": (3 * d,),
                       b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,), b + "ls1.gamma": (d,),
                       b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                       b + "mlp.fc1.weight": (hidden, d), b + "mlp.fc1.bias": (hidden,),
                       b + "mlp.fc2.weight": (d, hidden), b + "mlp.fc2.bias": (d,), b + "ls2.gamma": (d,)})
    shapes.update({p + "norm.weight": (d,), p + "norm.bias": (d,)})
    h = "depth_head."
    for i, c in enumerate(oc):
        shapes.update({f"{h}projects.{i}.weight": (c, d, 1, 1), f"{h}projects.{i}.bias": (c,)})
    shapes.update({h + "resize_layers.0.weight": (oc[0], oc[0], 4, 4), h + "resize_layers.0.bias": (oc[0],),
                   h + "resize_layers.1.weight": (oc[1], oc[1], 2, 2), h + "resize_layers.1.bias": (oc[1],),
                   h + "resize_layers.3.weight": (oc[3], oc[3], 3, 3), h + "resize_layers.3.bias": (oc[3],)})
    s = h + "scratch."
    for i, c in enumerate(oc):
        shapes[f"{s}layer{i + 1}_rn.weight"] = (f, c, 3, 3)
    for r in range(1, 5):
        for u in (1, 2):
            for conv in (1, 2):
                q = f"{s}refinenet{r}.resConfUnit{u}.conv{conv}."
                shapes.update({q + "weight": (f, f, 3, 3), q + "bias": (f,)})
        shapes.update({f"{s}refinenet{r}.out_conv.weight": (f, f, 1, 1), f"{s}refinenet{r}.out_conv.bias": (f,)})
    shapes.update({s + "output_conv1.weight": (f // 2, f, 3, 3), s + "output_conv1.bias": (f // 2,),
                   s + "output_conv2.0.weight": (32, f // 2, 3, 3), s + "output_conv2.0.bias": (32,),
                   s + "output_conv2.2.weight": (1, 32, 1, 1), s + "output_conv2.2.bias": (1,)})
    return shapes


QK_GAIN = 1.5  # q and k rows of qkv: attention logits of standard deviation ~QK_GAIN^2
OUT_BIAS = 2.0  # the last conv's bias: most pixels stay above the final ReLU


def draw_state_dict(seed: int, arch: dict = VITL) -> dict:
    """A state dict in upstream's layout drawn from `seed` (any non-negative
    integer), float32 on the host, so that the output means something:
    every weight of a linear layer or convolution normal at lecun scale
    (std 1 / sqrt(fan_in); a transposed conv's fan-in is its input
    channels, its kernels do not overlap), the q and k rows of qkv x
    QK_GAIN; biases N(0, 0.1^2), the last conv's OUT_BIAS; LayerNorm scale
    U(0.5, 1.5), shift N(0, 0.1^2); LayerScale gammas U(0.2, 0.5), so both
    branches move the residual stream in every block (upstream draws 1e-5
    for training); class token and position table N(0, 1), the size of
    the patch tokens; the mask token (unused at inference) zeros."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x44415632]))
    d = arch["embed_dim"]
    out = {}
    for key, shape in state_dict_shapes(arch).items():
        name = key.rsplit(".", 1)[-1]
        if key.endswith("mask_token"):
            a = np.zeros(shape, np.float32)
        elif key.endswith(("cls_token", "pos_embed")):
            a = rng.standard_normal(shape, np.float32)
        elif name == "gamma":
            a = rng.uniform(0.2, 0.5, shape).astype(np.float32)
        elif ".norm" in key and name == "weight":
            a = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif name == "weight":
            fan_in = shape[0] if "resize_layers.0" in key or "resize_layers.1" in key else int(np.prod(shape[1:]))
            a = rng.standard_normal(shape, np.float32) * np.float32(fan_in ** -0.5)
            if key.endswith("attn.qkv.weight"):
                a[: 2 * d] *= np.float32(QK_GAIN)
        else:  # biases
            a = rng.normal(0.0, 0.1, shape).astype(np.float32)
            if key.endswith("output_conv2.2.bias"):
                a[:] = OUT_BIAS
        out[key] = torch.from_numpy(a)
    return out
