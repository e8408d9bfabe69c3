"""A plain PyTorch MonoDepth2 (Godard et al., "Digging Into Self-Supervised
Monocular Depth Prediction", ICCV 2019; github.com/nianticlabs/monodepth2),
model mono_640x192: the reference that slamtpu_torch's MonoDepth2 is held
to, by the depth cells' check and by tests/test_torch_depth_plain.py.

Written from upstream's description, in functional torch and float32 with
TF32 off (both switches are set to False at import and before every call):

  * networks/resnet_encoder.py: torchvision's resnet18 on
    (image - 0.45) / 0.225; the features are conv1+bn1+relu, then layer1
    after the 3x3 stride-2 max pool, layer2, layer3 and layer4. A
    BasicBlock is conv3x3(stride)+bn+relu, conv3x3+bn, plus the identity
    (a 1x1 stride-s conv+bn where the stride or the width changes), relu.
  * networks/depth_decoder.py and layers.py: widths 16/32/64/128/256; for
    i = 4..0, upconv(i, 0) (ConvBlock: 3x3 conv after a reflection pad of
    1, bias, ELU), nearest x2 upsampling, concatenation with encoder
    feature i - 1 (i > 0), upconv(i, 1); dispconv(s) is a reflection-padded
    3x3 conv to one channel, then a sigmoid.

It reads state dicts in upstream's checkpoint layout: the encoder's keys
without their "encoder." prefix (torchvision's names), the decoder's as
`decoder.{k}.conv.conv.*` for upconv(i, j) at k = 2 (4 - i) + j and
`decoder.{10 + s}.conv.*` for dispconv(s). It imports torch and numpy only.

Departures from upstream:
  * The input: grayscale frames repeated to RGB, taken to float32 and
    downscaled with an antialiased bilinear filter (half-pixel centres),
    then divided by 255. Upstream's test_simple.py resizes an 8-bit RGB
    image with PIL's Lanczos filter before scaling.
  * Only the disparity heads asked for are computed (inference reads
    scale 0); upstream's decoder computes all four.
  * No training paths: BatchNorm always uses its running statistics
    (eps 1e-5, torchvision's), and nothing keeps gradients.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["PlainMonoDepth2", "encoder", "decoder", "preprocess", "draw_state_dicts", "ENC_CH", "DEC_CH"]

ENC_CH = (64, 64, 128, 256, 512)
DEC_CH = (16, 32, 64, 128, 256)
BLOCKS = (2, 2, 2, 2)  # resnet18
BN_EPS = 1e-5


def _tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_tf32_off()


def _bn(x, sd, p):
    return F.batch_norm(x, sd[p + "running_mean"], sd[p + "running_var"], sd[p + "weight"], sd[p + "bias"],
                        training=False, momentum=0.0, eps=BN_EPS)


def _basic_block(x, sd, p, stride):
    out = F.relu(_bn(F.conv2d(x, sd[p + "conv1.weight"], stride=stride, padding=1), sd, p + "bn1."))
    out = _bn(F.conv2d(out, sd[p + "conv2.weight"], padding=1), sd, p + "bn2.")
    if p + "downsample.0.weight" in sd:
        x = _bn(F.conv2d(x, sd[p + "downsample.0.weight"], stride=stride), sd, p + "downsample.1.")
    return F.relu(out + x)


def encoder(image, sd) -> list:
    """[B, 3, H, W] RGB in [0, 1] -> the five feature maps (H/2 to H/32)."""
    x = (image - 0.45) / 0.225
    x = F.relu(_bn(F.conv2d(x, sd["conv1.weight"], stride=2, padding=3), sd, "bn1."))
    features = [x]
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for stage, n_blocks in enumerate(BLOCKS, start=1):
        for b in range(n_blocks):
            x = _basic_block(x, sd, f"layer{stage}.{b}.", 2 if stage > 1 and b == 0 else 1)
        features.append(x)
    return features


def _conv3x3(x, sd, p):
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), sd[p + "weight"], sd[p + "bias"])


def decoder(features, sd, scales=(0,)) -> dict:
    """The five encoder features -> {s: [B, 1, H / 2^s, W / 2^s] sigmoid
    disparity} for s in `scales`."""
    x = features[-1]
    out = {}
    for i in range(4, -1, -1):
        x = F.elu(_conv3x3(x, sd, f"decoder.{2 * (4 - i)}.conv.conv."))
        x = [F.interpolate(x, scale_factor=2, mode="nearest")]
        if i > 0:
            x.append(features[i - 1])
        x = torch.cat(x, 1)
        x = F.elu(_conv3x3(x, sd, f"decoder.{2 * (4 - i) + 1}.conv.conv."))
        if i in scales:
            out[i] = torch.sigmoid(_conv3x3(x, sd, f"decoder.{10 + i}.conv."))
    return out


def preprocess(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B, H, W] grayscale in [0, 255] (any dtype) -> [B, 3, height, width]
    float32 RGB in [0, 1]."""
    x = frames.to(torch.float32)[:, None].expand(-1, 3, -1, -1)
    if x.shape[-2:] != (height, width):
        x = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=True)
    return x / 255.0


class PlainMonoDepth2:
    """The reference predictor on `device`, from state dicts in upstream's
    layout (tensors of any floating dtype; held here as float32)."""

    def __init__(self, encoder_sd: dict, decoder_sd: dict, width: int = 640, height: int = 192, device="cpu"):
        self.width, self.height, self.device = width, height, torch.device(device)
        self.enc = {k: v.to(self.device, torch.float32) for k, v in encoder_sd.items() if v.is_floating_point()}
        self.dec = {k: v.to(self.device, torch.float32) for k, v in decoder_sd.items() if v.is_floating_point()}

    @torch.no_grad()
    def predict_raw(self, frames) -> torch.Tensor:
        """[B, H, W] grayscale frames (host or device) -> [B, height, width]
        float32 scale-0 disparity on the device."""
        _tf32_off()
        x = preprocess(torch.as_tensor(frames).to(self.device), self.height, self.width)
        return decoder(encoder(x, self.enc), self.dec, scales=(0,))[0][:, 0]


def _conv_shapes():
    """(key, shape) of every convolution weight, and the names of the
    BatchNorm layers, of the encoder; the decoder's (weight, bias) shapes."""
    enc, bns = [("conv1.weight", (64, 3, 7, 7))], ["bn1."]
    c_in = ENC_CH[0]
    for stage, n_blocks in enumerate(BLOCKS, start=1):
        c = ENC_CH[stage]
        for b in range(n_blocks):
            p, cin = f"layer{stage}.{b}.", c_in if b == 0 else c
            enc += [(p + "conv1.weight", (c, cin, 3, 3)), (p + "conv2.weight", (c, c, 3, 3))]
            bns += [p + "bn1.", p + "bn2."]
            if b == 0 and (stage > 1 or cin != c):
                enc.append((p + "downsample.0.weight", (c, cin, 1, 1)))
                bns.append(p + "downsample.1.")
        c_in = c
    dec = []
    for i in range(4, -1, -1):
        cin = ENC_CH[-1] if i == 4 else DEC_CH[i + 1]
        dec.append((f"decoder.{2 * (4 - i)}.conv.conv.", (DEC_CH[i], cin, 3, 3)))
        cin = DEC_CH[i] + (ENC_CH[i - 1] if i > 0 else 0)
        dec.append((f"decoder.{2 * (4 - i) + 1}.conv.conv.", (DEC_CH[i], cin, 3, 3)))
    dec += [(f"decoder.{10 + s}.conv.", (1, DEC_CH[s], 3, 3)) for s in range(4)]
    return enc, bns, dec


def draw_state_dicts(seed: int):
    """(encoder, decoder) state dicts in upstream's layout, drawn from
    `seed` (any non-negative integer): convolution weights normal at
    lecun-normal scale (std 1 / sqrt(fan_in)), decoder biases N(0, 0.1^2),
    BatchNorm running mean N(0, 0.1^2), running var U(0.5, 1.5), scale
    U(0.5, 1.5), shift N(0, 0.1^2). float32 on the host."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x6D6F6E6F]))
    enc_w, bns, dec_w = _conv_shapes()

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def conv(shape):
        return t(rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape))

    enc = {key: conv(shape) for key, shape in enc_w}
    for p in bns:
        c = enc[p.replace("bn", "conv").replace("downsample.1.", "downsample.0.") + "weight"].shape[0]
        enc[p + "weight"] = t(rng.uniform(0.5, 1.5, c))
        enc[p + "bias"] = t(rng.normal(0.0, 0.1, c))
        enc[p + "running_mean"] = t(rng.normal(0.0, 0.1, c))
        enc[p + "running_var"] = t(rng.uniform(0.5, 1.5, c))
        enc[p + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    dec = {}
    for p, shape in dec_w:
        dec[p + "weight"] = conv(shape)
        dec[p + "bias"] = t(rng.normal(0.0, 0.1, shape[0]))
    return enc, dec
