"""A plain PyTorch SuperPoint + LightGlue: the reference that the port's
learned VO frontend (slamtpu_torch/feature/learned.py) is held to, by the
`splg` cells' check and by tests/test_torch_superpoint_lightglue.py.

Written from upstream's description, in functional torch and float32 with
TF32 off (both switches are set to False at import and before every call):

  * SuperPoint (DeTone et al., CVPRW 2018, arXiv:1712.07629), as the
    LightGlue repository's `superpoint.py` (github.com/cvg/LightGlue) runs
    it: 3x3 convolutions with ReLU, conv1a (1 -> 64), conv1b, a 2x2 max-pool,
    conv2a, conv2b (64), a pool, conv3a (64 -> 128), conv3b, a pool, conv4a,
    conv4b (128); the detector head convPa (3x3, 128 -> 256, ReLU), convPb
    (1x1, 256 -> 65), a softmax over the 65 channels, the dustbin dropped and
    the 64 channels unfolded into 8x8 pixels; `simple_nms` of radius 4; the
    4-pixel border at -1; the scores above 0.0005 by `torch.where` (row
    major) and the top 2048 of them by `torch.topk`, as (x, y); the
    descriptor head convDa (3x3, ReLU), convDb (1x1, 256 -> 256),
    L2-normalised, bilinear `grid_sample` (align_corners=True) at
    (kp - s/2 + 0.5) / (w s - s/2 - 0.5, h s - s/2 - 0.5) * 2 - 1, s = 8, and
    L2-normalised again.
  * LightGlue (Lindenberger et al., ICCV 2023, arXiv:2306.13643),
    `LightGlue(features="superpoint")` with adaptive depth and width off
    (depth_confidence = width_confidence = -1), on one pair's live
    keypoints (upstream's unpadded path, no masks): the keypoints centred
    and divided by half the image's longer side; the Fourier position
    encoding (Wr, 2 -> 32, no bias; cos and sin, each repeated twice,
    interleaved); 9 layers of a self block (Wqkv unflattened as (4, 64, 3),
    rotary q and k with `rotate_half` over adjacent channel pairs,
    attention written out, out_proj, x + ffn(cat[x, message]) with
    ffn = Linear 512, LayerNorm, exact GELU, Linear 256) on each image, then
    the bidirectional cross block with one similarity matrix and a softmax
    along each of its axes (upstream's non-flash formula); the last
    layer's assignment: final_proj on each side over 256^(1/4), the
    similarity, log_softmax along rows plus along columns plus
    log-sigmoid of the matchability of each side, the dustbins
    log-sigmoid(-z); `filter_matches` at 0.1 (mutual arg-max, exp(score)
    above the threshold).

It reads state dicts in upstream's layout (SuperPoint's `conv1a.weight`
...; LightGlue's `posenc.Wr.weight`, `transformers.{i}.*`,
`log_assignment.{i}.*`, `token_confidence.{i}.*`). It imports torch and
numpy only, nothing of the port.

Departure from upstream: none in the arithmetic; the port's fixed slots
and masks have no counterpart here (each image holds only its live
keypoints).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["SP", "LG", "superpoint_dense", "keypoint_scores", "simple_nms", "select_keypoints",
           "normalize_descriptors", "sample_descriptors", "superpoint", "lightglue", "filter_matches",
           "state_dict_shapes", "draw_state_dict"]

# superpoint.py's defaults with LightGlue's relative-pose budget, and LightGlue(features="superpoint").
SP = dict(descriptor_dim=256, nms_radius=4, detection_threshold=0.0005, remove_borders=4, max_num_keypoints=2048)
LG = dict(descriptor_dim=256, n_layers=9, num_heads=4, filter_threshold=0.1)
CELL = 8

# The drawn weights' scales (draw_state_dict).
QK_STD = 1.4  # q and k weights (the stream is unit-norm): attention logits of std ~2
FFN_OUT_STD = 5e-4  # the ffns' last weights: each block moves the stream by a few percent
FINAL_PROJ_GAIN = 40.0  # final_proj ~ 40 I: a similarity of 100 x the descriptors' cosine
CALIBRATION = (128, 128)  # the seeded image on which convDb is centred
CENTRED_DIRECTIONS = 8  # the principal directions of convDa's features that convDb is projected off
MATCHABILITY_BIAS = 2.0  # sigmoid(2) = 0.88: most slots matchable

# SuperPoint's detector channels (_detector): a peak finder built into the
# network's own layers, so that keypoints sit on the scene's structure.
BACKGROUND = 96.0 / 255.0  # the rendered scene's gray (benchmark/inputs/scene.py)
DEVIATION_FLOOR = 0.02  # D = |blurred image - BACKGROUND| - this, at least 0
BIT_GAIN = 20.0  # a window comparison saturates at the block's peak once it differs by 1/20 of it
SLOPE_GAIN = 20.0  # a block whose peak a neighbouring pixel beats loses 20 x the excess
SLOPE_TOLERANCE = 0.008  # excesses below this (bfloat16 rounding) do not count
POSITION_GAIN = 10.0  # logit per unit of peak height and bit, the finest bit; x2, x4 the coarser
DUSTBIN_BIAS = 12.0  # a cell with no peak: every pixel's score 1 / (64 + e^12), under the threshold
DEAD_GAIN = 100.0  # the dustbin's logit per unit of a cell peak that is not a reliable peak
LOGIT_NOISE = 1e-3  # convPb's weights from the other channels: breaks exact ties

_DETECTOR_SHIFTS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0))  # (dy, dx): the block, +x, -x, +y, -y


def _tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


_tf32_off()


# -- SuperPoint ---------------------------------------------------------------

_SP_CONVS = (("conv1a", 1, 64, 3), ("conv1b", 64, 64, 3), ("conv2a", 64, 64, 3), ("conv2b", 64, 64, 3),
             ("conv3a", 64, 128, 3), ("conv3b", 128, 128, 3), ("conv4a", 128, 128, 3), ("conv4b", 128, 128, 3),
             ("convPa", 128, 256, 3), ("convPb", 256, 65, 1), ("convDa", 128, 256, 3), ("convDb", 256, 256, 1))


def _conv(x, sd, name):
    w = sd[name + ".weight"]
    return F.conv2d(x, w, sd[name + ".bias"], padding=w.shape[-1] // 2)


def superpoint_dense(sd: dict, image: torch.Tensor) -> tuple:
    """[B, 1, H, W] in [0, 1] -> (logits [B, 65, h, w], descriptors
    [B, 256, h, w] before their normalisation)."""
    _tf32_off()
    x = image
    for a, b in (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b")):
        x = F.max_pool2d(F.relu(_conv(F.relu(_conv(x, sd, a)), sd, b)), 2, 2)
    x = F.relu(_conv(F.relu(_conv(x, sd, "conv4a")), sd, "conv4b"))
    return _conv(F.relu(_conv(x, sd, "convPa")), sd, "convPb"), _conv(F.relu(_conv(x, sd, "convDa")), sd, "convDb")


def keypoint_scores(logits: torch.Tensor) -> torch.Tensor:
    scores = F.softmax(logits, 1)[:, :-1]
    b, _, h, w = scores.shape
    scores = scores.permute(0, 2, 3, 1).reshape(b, h, w, CELL, CELL)
    return scores.permute(0, 1, 3, 2, 4).reshape(b, h * CELL, w * CELL)


def simple_nms(scores: torch.Tensor, nms_radius: int) -> torch.Tensor:
    def max_pool(x):
        return F.max_pool2d(x, kernel_size=nms_radius * 2 + 1, stride=1, padding=nms_radius)

    zeros = torch.zeros_like(scores)
    max_mask = scores == max_pool(scores)
    for _ in range(2):
        supp_mask = max_pool(max_mask.float()) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == max_pool(supp_scores)
        max_mask = max_mask | (new_max_mask & (~supp_mask))
    return torch.where(max_mask, scores, zeros)


def select_keypoints(scores: torch.Tensor, k: int, threshold: float, border: int) -> tuple:
    """One frame's NMS scores [H, W] -> (keypoints [n, 2] float32 (x, y),
    scores [n]), n <= k: upstream's border, threshold and top-k."""
    scores = scores.clone()
    if border:
        scores[:border] = -1
        scores[:, :border] = -1
        scores[-border:] = -1
        scores[:, -border:] = -1
    best = torch.where(scores > threshold)
    kp, s = torch.stack(best, dim=-1), scores[best]
    if k < len(kp):
        s, idx = torch.topk(s, k, dim=0, sorted=True)
        kp = kp[idx]
    return torch.flip(kp, [1]).float(), s


def normalize_descriptors(descriptors: torch.Tensor) -> torch.Tensor:
    return F.normalize(descriptors, p=2, dim=1)


def sample_descriptors(keypoints: torch.Tensor, descriptors: torch.Tensor, s: int = CELL) -> torch.Tensor:
    """Keypoints [n, 2] in one frame's normalised coarse map [1, D, h, w] ->
    [n, D]."""
    _, c, h, w = descriptors.shape
    keypoints = keypoints - s / 2 + 0.5
    keypoints = keypoints / torch.tensor([(w * s - s / 2 - 0.5), (h * s - s / 2 - 0.5)]).to(keypoints)[None]
    keypoints = keypoints * 2 - 1
    out = F.grid_sample(descriptors, keypoints.view(1, 1, -1, 2), mode="bilinear", align_corners=True)
    return F.normalize(out.reshape(1, c, -1), p=2, dim=1)[0].transpose(0, 1)


def superpoint(sd: dict, frames: torch.Tensor, conf: dict = SP) -> list:
    """Frames [B, H, W] in [0, 255] -> per frame a dict: logits, coarse
    (normalised descriptors), keypoints [n, 2], scores [n], descriptors
    [n, D]."""
    image = frames.to(torch.float32)[:, None] / 255.0
    logits, desc = superpoint_dense(sd, image)
    scores = simple_nms(keypoint_scores(logits), conf["nms_radius"])
    coarse = normalize_descriptors(desc)
    out = []
    for i in range(len(frames)):
        kp, s = select_keypoints(scores[i], conf["max_num_keypoints"], conf["detection_threshold"],
                                 conf["remove_borders"])
        out.append(dict(logits=logits[i], coarse=coarse[i], keypoints=kp, scores=s,
                        descriptors=sample_descriptors(kp, coarse[i : i + 1])))
    return out


# -- LightGlue ----------------------------------------------------------------

def _linear(x, sd, p):
    return F.linear(x, sd[p + ".weight"], sd[p + ".bias"])


def _ffn(x, sd, p):
    h = _linear(x, sd, p + ".0")
    h = F.layer_norm(h, h.shape[-1:], sd[p + ".1.weight"], sd[p + ".1.bias"])
    return _linear(F.gelu(h), sd, p + ".3")


def _rotate_half(x):
    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x.unbind(dim=-1)
    return torch.stack((-x2, x1), dim=-1).flatten(start_dim=-2)


def _rotary(freqs, t):
    return (t * freqs[0]) + (_rotate_half(t) * freqs[1])


def _softmax_attention(q, k, v):
    sim = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(F.softmax(sim, -1), v)


def _self_block(x, encoding, sd, p, heads):
    qkv = _linear(x, sd, p + ".Wqkv").unflatten(-1, (heads, -1, 3)).transpose(0, 1)  # [heads, n, d, 3]
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    q, k = _rotary(encoding, q), _rotary(encoding, k)
    message = _linear(_softmax_attention(q, k, v).transpose(0, 1).flatten(start_dim=-2), sd, p + ".out_proj")
    return x + _ffn(torch.cat([x, message], -1), sd, p + ".ffn")


def _cross_block(x0, x1, sd, p, heads):
    qk0, qk1, v0, v1 = (_linear(x, sd, p + name).unflatten(-1, (heads, -1)).transpose(0, 1)
                        for name, x in ((".to_qk", x0), (".to_qk", x1), (".to_v", x0), (".to_v", x1)))
    scale = qk0.shape[-1] ** -0.5
    qk0, qk1 = qk0 * scale**0.5, qk1 * scale**0.5
    sim = torch.matmul(qk0, qk1.transpose(-1, -2))  # [heads, m, n]
    attn01 = F.softmax(sim, dim=-1)
    attn10 = F.softmax(sim.transpose(-2, -1).contiguous(), dim=-1)
    m0 = torch.matmul(attn01, v1)
    m1 = torch.matmul(attn10, v0)
    m0, m1 = (_linear(m.transpose(0, 1).flatten(start_dim=-2), sd, p + ".to_out") for m in (m0, m1))
    return x0 + _ffn(torch.cat([x0, m0], -1), sd, p + ".ffn"), x1 + _ffn(torch.cat([x1, m1], -1), sd, p + ".ffn")


def _posenc(kpts, sd):
    projected = F.linear(kpts, sd["posenc.Wr.weight"])
    emb = torch.stack([torch.cos(projected), torch.sin(projected)], 0).unsqueeze(-3)
    return emb.repeat_interleave(2, dim=-1)  # [2, 1, n, 64]


def _normalize_keypoints(kpts, size):
    size = torch.tensor(size, dtype=kpts.dtype, device=kpts.device)
    shift = size / 2
    scale = size.max(-1).values / 2
    return (kpts - shift[None]) / scale


def lightglue(sd: dict, kpts0, kpts1, desc0, desc1, size: tuple, conf: dict = LG) -> dict:
    """One pair's live keypoints [m, 2], [n, 2] (pixels) and descriptors
    [m, D], [n, D] in images of size (w, h) -> dict of the log-assignment
    [m + 1, n + 1], matches0 [m] (-1 where none) and mscores0 [m]."""
    _tf32_off()
    heads, layers = conf["num_heads"], conf["n_layers"]
    enc0, enc1 = _posenc(_normalize_keypoints(kpts0, size), sd), _posenc(_normalize_keypoints(kpts1, size), sd)
    x0, x1 = desc0, desc1
    for i in range(layers):
        p = f"transformers.{i}"
        x0 = _self_block(x0, enc0, sd, p + ".self_attn", heads)
        x1 = _self_block(x1, enc1, sd, p + ".self_attn", heads)
        x0, x1 = _cross_block(x0, x1, sd, p + ".cross_attn", heads)
    p = f"log_assignment.{layers - 1}"
    d = x0.shape[-1]
    md0, md1 = _linear(x0, sd, p + ".final_proj") / d**0.25, _linear(x1, sd, p + ".final_proj") / d**0.25
    sim = torch.matmul(md0, md1.transpose(-1, -2))
    z0, z1 = _linear(x0, sd, p + ".matchability"), _linear(x1, sd, p + ".matchability")
    m, n = sim.shape
    certainties = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(0, 1)
    scores0 = F.log_softmax(sim, 1)
    scores1 = F.log_softmax(sim.transpose(-1, -2).contiguous(), 1).transpose(-1, -2)
    scores = sim.new_full((m + 1, n + 1), 0)
    scores[:m, :n] = scores0 + scores1 + certainties
    scores[:-1, -1] = F.logsigmoid(-z0.squeeze(-1))
    scores[-1, :-1] = F.logsigmoid(-z1.squeeze(-1))
    m0, mscores0 = filter_matches(scores, conf["filter_threshold"])
    return dict(log_assignment=scores, matches0=m0, mscores0=mscores0)


def filter_matches(scores: torch.Tensor, th: float) -> tuple:
    """Upstream's `filter_matches` on one pair's [m + 1, n + 1]: (matches0
    [m], mscores0 [m])."""
    if scores.shape[0] < 2 or scores.shape[1] < 2:  # an image with no keypoint matches nothing
        return torch.full((scores.shape[0] - 1,), -1, dtype=torch.int64), torch.zeros(scores.shape[0] - 1)
    max0, max1 = scores[:-1, :-1].max(1), scores[:-1, :-1].max(0)
    m0, m1 = max0.indices, max1.indices
    indices0 = torch.arange(m0.shape[0], device=m0.device)
    mutual0 = indices0 == m1.gather(0, m0)
    max0_exp = max0.values.exp()
    zero = max0_exp.new_tensor(0)
    mscores0 = torch.where(mutual0, max0_exp, zero)
    valid0 = mutual0 & (mscores0 > th)
    return torch.where(valid0, m0, -1), mscores0


# -- weights ------------------------------------------------------------------

def state_dict_shapes(sp_conf: dict = SP, lg_conf: dict = LG) -> tuple:
    """({key: shape} of SuperPoint, {key: shape} of LightGlue) in upstream's
    layout."""
    sp = {}
    for name, cin, cout, k in _SP_CONVS:
        cout = sp_conf["descriptor_dim"] if name == "convDb" else cout
        sp[f"{name}.weight"], sp[f"{name}.bias"] = (cout, cin, k, k), (cout,)
    d, n = lg_conf["descriptor_dim"], lg_conf["n_layers"]
    lg = {"posenc.Wr.weight": (d // lg_conf["num_heads"] // 2, 2)}
    lin = lambda p, i, o: {f"{p}.weight": (o, i), f"{p}.bias": (o,)}  # noqa: E731

    def ffn(p):
        return {**lin(p + ".0", 2 * d, 2 * d), f"{p}.1.weight": (2 * d,), f"{p}.1.bias": (2 * d,),
                **lin(p + ".3", 2 * d, d)}

    for i in range(n):
        p = f"transformers.{i}"
        lg.update(lin(p + ".self_attn.Wqkv", d, 3 * d))
        lg.update(lin(p + ".self_attn.out_proj", d, d))
        lg.update(ffn(p + ".self_attn.ffn"))
        for name in ("to_qk", "to_v", "to_out"):
            lg.update(lin(f"{p}.cross_attn.{name}", d, d))
        lg.update(ffn(p + ".cross_attn.ffn"))
    for i in range(n):
        lg.update(lin(f"log_assignment.{i}.matchability", d, 1))
        lg.update(lin(f"log_assignment.{i}.final_proj", d, d))
    for i in range(n - 1):
        lg.update(lin(f"token_confidence.{i}.token.0", d, 1))
    return sp, lg


def _detector(sp: dict, rng) -> None:
    """Write SuperPoint's detector into the first channels of the drawn
    state dict `sp` (numpy arrays, in place): a peak finder built from the
    network's own layers, so that a keypoint is the pixel where
    D = relu(|3x3 blur of the image - BACKGROUND| - DEVIATION_FLOOR) peaks.

    Each 2x2 max-pool halves the resolution; before it, the block's D (its
    maximum) is also taken over windows shifted by one block each way
    (+-x, +-y). After it, the sign of (window +x) - (window -x) says in
    which half of the block the maximum lies: a bit of its position,
    saturated at the block's peak height by relu(g d) - relu(g d - peak).
    Three levels give the three bits of x and of y within an 8x8 cell.
    convPb's logit of pixel (y, x) of the cell adds POSITION_GAIN x 1, 2,
    4 x each bit signed by that pixel's bit, so the cell's most likely
    pixel is its D maximum. A block whose peak a pixel just outside it
    beats (a slope, not a peak) loses its bits and its "reliable" height
    (SLOPE_GAIN per unit of excess); a cell whose peak is not reliable
    (the pixels next to it are higher) gets the difference x DEAD_GAIN on
    its dustbin, so slopes of a larger blob make no keypoints. Every other
    channel stays as drawn and feeds the descriptors.
    """
    g, lam = BIT_GAIN, SLOPE_GAIN

    def clear(name, n):
        sp[name + ".weight"][:n] = 0.0
        sp[name + ".bias"][:n] = 0.0

    def tap(name, out, inp, v, dy=0, dx=0):
        sp[name + ".weight"][out, inp, 1 + dy, 1 + dx] += v

    def shifts(name, row, src):  # rows row..row+4: src at the five shifts
        for j, (dy, dx) in enumerate(_DETECTOR_SHIFTS):
            tap(name, row + j, src, 1.0, dy, dx)

    def comparisons(name, row, peak):  # rows row..row+7: relu(+-g d), relu(+-g d - peak), x then y
        for axis in (0, 1):
            plus, minus = peak + 1 + 2 * axis, peak + 2 + 2 * axis
            for r, sign, cap in ((0, 1, False), (1, 1, True), (2, -1, False), (3, -1, True)):
                tap(name, row + 4 * axis + r, plus, sign * g)
                tap(name, row + 4 * axis + r, minus, -sign * g)
                if cap:
                    tap(name, row + 4 * axis + r, peak, -1.0)

    def slopes(name, row, peak):  # rows row..row+3: relu(window - block's peak - tolerance)
        for j in range(4):
            tap(name, row + j, peak + 1 + j, 1.0)
            tap(name, row + j, peak, -1.0)
            sp[name + ".bias"][row + j] = -SLOPE_TOLERANCE

    def bits(name, row, src, slope=None):  # rows row..row+3: +x, -x, +y, -y parts, less a slope's
        for j in range(4):
            tap(name, row + j, src + 2 * j, 1.0)
            tap(name, row + j, src + 2 * j + 1, -1.0)
            for k in range(4 if slope is not None else 0):
                tap(name, row + j, slope + k, -lam)

    def reliable(name, row, src, slope):  # row: relu(src - SLOPE_GAIN x the slopes)
        tap(name, row, src, 1.0)
        for k in range(4):
            tap(name, row, slope + k, -lam)

    def passthru(name, row, src, n=1):
        for j in range(n):
            tap(name, row + j, src + j, 1.0)

    # Full resolution: bright and dark deviation of the blurred image; D at the shifts.
    clear("conv1a", 2)
    blur = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0]).astype(np.float32) / 16
    sp["conv1a.weight"][0, 0], sp["conv1a.weight"][1, 0] = blur, -blur
    sp["conv1a.bias"][:2] = -(BACKGROUND + DEVIATION_FLOOR), BACKGROUND - DEVIATION_FLOOR
    clear("conv1b", 5)
    for j, (dy, dx) in enumerate(_DETECTOR_SHIFTS):
        tap("conv1b", j, 0, 1.0, dy, dx)
        tap("conv1b", j, 1, 1.0, dy, dx)
    # Level 1 (2x2 blocks), in: 0-4 window maxima.
    clear("conv2a", 17)
    shifts("conv2a", 0, 0)
    comparisons("conv2a", 5, 0)
    slopes("conv2a", 13, 0)
    clear("conv2b", 10)
    passthru("conv2b", 0, 0, 5)
    bits("conv2b", 5, 5, slope=13)
    reliable("conv2b", 9, 0, 13)
    # Level 2 (4x4), in: 0-4 window maxima, 5-8 level-1 bits, 9 reliable height.
    clear("conv3a", 22)
    shifts("conv3a", 0, 0)
    comparisons("conv3a", 5, 0)
    passthru("conv3a", 13, 5, 4)
    slopes("conv3a", 17, 0)
    passthru("conv3a", 21, 9)
    clear("conv3b", 14)
    passthru("conv3b", 0, 0, 5)
    bits("conv3b", 5, 5, slope=17)
    passthru("conv3b", 9, 13, 4)
    reliable("conv3b", 13, 21, 17)
    # Level 3 (the 8x8 cells), in: 0-4 window maxima, 5-8 level-2 bits, 9-12 level-1 bits, 13 reliable.
    clear("conv4a", 26)
    passthru("conv4a", 0, 0, 5)
    comparisons("conv4a", 5, 0)
    passthru("conv4a", 13, 5, 8)
    passthru("conv4a", 21, 13)
    slopes("conv4a", 22, 0)
    clear("conv4b", 14)
    passthru("conv4b", 0, 0)
    bits("conv4b", 1, 5)
    passthru("conv4b", 5, 13, 8)
    reliable("conv4b", 13, 21, 22)
    # convPa: the bits, and how far the cell's peak is from a reliable one.
    clear("convPa", 14)
    passthru("convPa", 0, 0, 13)
    tap("convPa", 13, 0, 1.0)
    tap("convPa", 13, 13, -1.0)
    sp["convPa.bias"][13] = -SLOPE_TOLERANCE
    # convPb: pixel (y, x) of the cell is channel 8 y + x; the 65th is the dustbin.
    wpb = sp["convPb.weight"]
    wpb[:] = rng.standard_normal(wpb.shape, np.float32) * np.float32(LOGIT_NOISE)
    wpb[:, :14] = 0.0
    sp["convPb.bias"][:] = 0.0
    for k in range(64):
        for level, src in ((3, 1), (2, 5), (1, 9)):  # conv4b's bits of each level
            w = POSITION_GAIN * 2 ** (level - 1)
            for axis, coord in ((0, k % 8), (1, k // 8)):
                bit = 1.0 if (coord >> (level - 1)) & 1 else -1.0
                wpb[k, src + 2 * axis, 0, 0] = w * bit
                wpb[k, src + 2 * axis + 1, 0, 0] = -w * bit
    wpb[64, 13, 0, 0] = DEAD_GAIN
    sp["convPb.bias"][64] = DUSTBIN_BIAS


def draw_state_dict(seed: int, sp_conf: dict = SP, lg_conf: dict = LG) -> dict:
    """{"superpoint": ..., "lightglue": ...}: state dicts in upstream's
    layout drawn from `seed` (any non-negative integer), float32 on the
    host, so that the output means something:

      * SuperPoint: every convolution He-normal (std sqrt(2 / fan_in)),
        biases N(0, 0.01^2); then the detector written into the first
        channels of each layer and all of convPb (_detector), so the
        keypoints are the peaks of the scene's blobs; convDb's weights
        projected off the CENTRED_DIRECTIONS top principal directions of
        convDa's features on a seeded CALIBRATION-sized scene-like image
        (gray 0.4 with smoothed noise), and its bias off their mean, so the
        descriptors do not share one direction.
      * LightGlue: linear weights lecun-normal (std 1 / sqrt(fan_in)),
        biases N(0, 0.01^2); the q and k rows of Wqkv and to_qk at std
        QK_STD, so attention over 2048 tokens is not near-uniform; each
        ffn's last weights and bias at std FFN_OUT_STD, so every residual branch is
        small next to the unit-norm stream; LayerNorm scale U(0.8, 1.2),
        shift N(0, 0.05^2); final_proj FINAL_PROJ_GAIN x I plus
        N(0, 0.05^2), so the assignment is sharp and its mutual matches
        follow the descriptors; the matchability weights N(0, 1) and bias
        MATCHABILITY_BIAS, so most slots are matchable; Wr N(0, 1)
        (upstream's init); token_confidence lecun (not run).
    """
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x53504C47]))
    sp_shapes, lg_shapes = state_dict_shapes(sp_conf, lg_conf)
    normal = lambda shape, std: (rng.standard_normal(shape, np.float32) * np.float32(std))  # noqa: E731
    sp = {}
    for key, shape in sp_shapes.items():
        std = (2.0 / np.prod(shape[1:])) ** 0.5 if key.endswith(".weight") else 0.01
        sp[key] = normal(shape, std)
    _detector(sp, rng)
    sp = {key: torch.from_numpy(a) for key, a in sp.items()}
    # Centre the descriptors: convDa's ReLU features share a few dominant
    # directions, which convDb would pass to every descriptor alike; its
    # weights are projected off them (the top principal directions of those
    # features on a seeded scene-like image) and its bias off their mean.
    noise = torch.from_numpy(rng.uniform(0.0, 1.0, (1, 1, *CALIBRATION)).astype(np.float32))
    image = (0.4 + 0.6 * (F.avg_pool2d(noise, 5, stride=1, padding=2, count_include_pad=False) - 0.5)).clamp(0, 1)
    with torch.no_grad():
        x = image
        for a, b in (("conv1a", "conv1b"), ("conv2a", "conv2b"), ("conv3a", "conv3b")):
            x = F.max_pool2d(F.relu(_conv(F.relu(_conv(x, sp, a)), sp, b)), 2, 2)
        x = F.relu(_conv(F.relu(_conv(x, sp, "conv4a")), sp, "conv4b"))
        feats = F.relu(_conv(x, sp, "convDa")).flatten(2)[0].T.double()  # [cells, 256]
        _, _, v = torch.linalg.svd(feats, full_matrices=False)
        top = v[:CENTRED_DIRECTIONS].T  # [256, n]
        w = sp["convDb.weight"][:, :, 0, 0].double()
        w = w - (w @ top) @ top.T
        sp["convDb.weight"] = w.float()[:, :, None, None].contiguous()
        sp["convDb.bias"] = sp["convDb.bias"] - (feats.mean(0) @ w.T).float()
    d = lg_conf["descriptor_dim"]
    lg = {}
    for key, shape in lg_shapes.items():
        if key == "posenc.Wr.weight":
            a = normal(shape, 1.0)
        elif key.endswith(".1.weight"):  # the ffns' LayerNorm
            a = rng.uniform(0.8, 1.2, shape).astype(np.float32)
        elif key.endswith(".1.bias"):
            a = normal(shape, 0.05)
        elif key.endswith("final_proj.weight"):
            a = np.eye(d, dtype=np.float32) * np.float32(FINAL_PROJ_GAIN) + normal(shape, 0.05)
        elif key.endswith("matchability.weight"):
            a = normal(shape, 1.0)
        elif key.endswith("matchability.bias"):
            a = np.full(shape, MATCHABILITY_BIAS, np.float32)
        elif key.endswith(".weight"):
            a = normal(shape, shape[1] ** -0.5)
            if key.endswith("Wqkv.weight"):
                rows = np.arange(shape[0]) % 3 < 2  # (heads, 64, 3): q and k rows, then v
                a[rows] = normal((int(rows.sum()), shape[1]), QK_STD)
            elif key.endswith("to_qk.weight"):
                a = normal(shape, QK_STD)
            elif key.endswith("ffn.3.weight"):
                a = normal(shape, FFN_OUT_STD)
        elif key.endswith("ffn.3.bias"):
            a = normal(shape, FFN_OUT_STD)
        else:
            a = normal(shape, 0.01)
        lg[key] = torch.from_numpy(a)
    return {"superpoint": sp, "lightglue": lg}
