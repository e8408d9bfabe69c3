"""Batches of frames through the port's `DepthAnythingV2.predict_raw`, one
pass over the scene's frames a request (a closed loop with one client):
the frames go in as host uint8 grayscale, in an order permuted from the
run's seed and the request, in calls of the mix's batch (the last one
shorter where the frames do not split), and each call's float32 inverse
depth at the model's size is fetched to the host before the next call.
The weights are drawn from the seed in upstream's checkpoint layout
(benchmark/reference/plaindav2/depth_anything.py::draw_state_dict) and
loaded through `DepthAnythingV2(state_dict=...)` with strict=True.

A request keeps a small answer: `keep_frames` whole frames and an
average-pooled thumbnail of `thumbnail_frames` frames, both drawn from the
seed and the request. The check runs the plain reference (float32, TF32
off) over those frames in blocks of `check_block` and reads, each gap
relative to the reference frame's p95 - p5 spread (the output is
unbounded, defined up to scale and shift):

  inv_gap_rel_max    the largest |port - reference| over the kept frames;
  inv_rel_rms_max    per kept frame, the rms of the gap over the
                     reference's standard deviation, the largest;
  thumb_gap_rel_max  the largest gap over the thumbnails;
  ref_zero_share     (a reading, not a limit) the share of the reference's
                     pixels the final ReLU clips to 0;
  ref_spread_min     (a reading, not a limit) the smallest p95 - p5 spread
                     of a reference frame.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.plaindav2 import depth_anything as plain

WIDTHS = ("embed_dim", "depth", "num_heads", "mlp_ratio", "patch_size", "img_size", "layers", "features",
          "out_channels")


def arch(model: dict) -> dict:
    """The model's widths, as the reference and the port's config take them."""
    return {k: tuple(model[k]) if isinstance(model[k], list) else model[k] for k in WIDTHS}


def port_program(weights: dict, model: dict, device):
    """The port's DepthAnythingV2 as the depth CLI builds it."""
    from slamtpu_torch.depth.depth_anything import DepthAnythingV2, DepthAnythingV2Config

    return DepthAnythingV2(state_dict=weights, input_size=model["input_size"],
                           compute_dtype=getattr(torch, model["compute_dtype"]), device=device,
                           config=DepthAnythingV2Config(**arch(model)))


def reference_program(weights: dict, model: dict, device, frame_block: int = 4):
    """The plain reference, float32."""
    return plain.PlainDepthAnythingV2(weights, arch(model), model["input_size"], device, frame_block)


def _thumbnails(inv: torch.Tensor, pool: int) -> torch.Tensor:
    # The network has no average pooling, so this kernel is the driver's
    # alone: benchmark/inputs/dav2_counts.py classes it apart.
    return F.avg_pool2d(inv[:, None], pool)[:, 0]


def _spread(frames: np.ndarray) -> np.ndarray:
    p5, p95 = np.percentile(frames.reshape(len(frames), -1), [5, 95], axis=1)
    return p95 - p5


def numbers(port_kept, ref_kept, port_thumbs, ref_thumbs, thumb_spread) -> dict:
    """The compared numbers of one answer against the reference's; the
    thumbnails' gaps are relative to their full frames' spread."""
    gap = np.abs(port_kept.astype(np.float64) - ref_kept)
    spread = np.maximum(_spread(ref_kept), 1e-12)
    rms = np.sqrt((gap ** 2).mean(axis=(1, 2)))
    std = np.maximum(ref_kept.reshape(len(ref_kept), -1).std(axis=1), 1e-12)
    thumb_gap = np.abs(port_thumbs.astype(np.float64) - ref_thumbs).reshape(len(ref_thumbs), -1).max(axis=1)
    return dict(inv_gap_rel_max=float(np.max(gap.reshape(len(gap), -1).max(axis=1) / spread)),
                inv_rel_rms_max=float(np.max(rms / std)),
                thumb_gap_rel_max=float(np.max(thumb_gap / np.maximum(thumb_spread, 1e-12))))


class Driver:
    def __init__(self, config: dict, traffic: dict, scene, seed: int, device, program=None):
        self.model_cfg, self.traffic, self.seed, self.device = config["model"], traffic, int(seed), device
        self.frames = scene.frames  # [N, H, W] host uint8, as a user holds decoded frames
        self.batch = int(traffic["batch"])
        self.pool, self.n_keep = int(traffic["thumbnail_pool"]), int(traffic["keep_frames"])
        self.n_thumb = min(int(traffic["thumbnail_frames"]), len(self.frames))
        self.weights = plain.draw_state_dict(self.seed, arch(self.model_cfg))
        self.model = (program or port_program)(self.weights, self.model_cfg, device)
        self.size = plain.target_size(*self.frames.shape[1:], self.model_cfg["input_size"],
                                      self.model_cfg["patch_size"])
        self.block = np.empty((self.batch, *self.frames.shape[1:]), np.uint8)
        self._reference = {}

    def _order(self, i: int):
        """The request's frame order, its kept frames and its thumbnails'
        frames (each sorted)."""
        rng = np.random.default_rng([self.seed, int(i) + 1])
        n = len(self.frames)
        return (rng.permutation(n), np.sort(rng.choice(n, self.n_keep, replace=False)),
                np.sort(rng.choice(n, self.n_thumb, replace=False)))

    def request(self, i: int) -> dict:
        order, keep, thumb = self._order(i)
        h, w = self.size
        kept = np.empty((len(keep), h, w), np.float32)
        thumbs = np.empty((len(thumb), h // self.pool, w // self.pool), np.float32)
        where_keep = {int(f): k for k, f in enumerate(keep)}
        where_thumb = {int(f): k for k, f in enumerate(thumb)}
        for start in range(0, len(order), self.batch):
            idx = order[start : start + self.batch]
            block = self.block[: len(idx)]  # the last call is shorter where the frames do not split
            np.take(self.frames, idx, axis=0, out=block, mode="clip")  # unbuffered; idx is in range
            inv = self.model.predict_raw(block)  # [len(idx), h, w] float32 on the device
            with torch.no_grad():
                small = _thumbnails(inv, self.pool)
            host = inv.cpu().numpy()
            small = small.cpu().numpy()
            for j, f in enumerate(idx.tolist()):
                if f in where_keep:
                    kept[where_keep[f]] = host[j]
                if f in where_thumb:
                    thumbs[where_thumb[f]] = small[j]
        return dict(frames=len(order), detected=order.tolist(),
                    answer=dict(keep=keep, kept=kept, thumb=thumb, thumbs=thumbs))

    def warmup(self) -> None:
        self.request(-1)

    def _reference_pass(self, keep, thumb) -> tuple:
        """The reference's kept frames, thumbnails, its thumbnails' frames'
        spreads, and its zero share and smallest spread over every frame it
        ran, over the union of the kept and thumbnail frames in blocks of
        the mix's `check_block` frames."""
        key = (tuple(int(f) for f in keep), tuple(int(f) for f in thumb))
        if key not in self._reference:
            step = int(self.traffic["check_block"])
            ref = reference_program(self.weights, self.model_cfg, self.device, step)
            union = sorted(set(key[0]) | set(key[1]))
            full, small = {}, {}
            for start in range(0, len(union), step):
                idx = union[start : start + step]
                inv = ref.predict_raw(self.frames[idx])
                small.update(zip(idx, _thumbnails(inv, self.pool).cpu().numpy()))
                full.update(zip(idx, inv.cpu().numpy()))
            every = np.stack([full[f] for f in union])
            thumb_spread = _spread(np.stack([full[f] for f in key[1]]))
            self._reference = {key: (np.stack([full[f] for f in key[0]]), np.stack([small[f] for f in key[1]]),
                                     thumb_spread, float(np.mean(every == 0)), float(_spread(every).min()))}
        return self._reference[key]

    def check(self, answer, reference=None) -> dict:
        """The compared numbers; `reference` (the VO programs' namespace the
        harness passes) is not used."""
        ref_kept, ref_thumbs, thumb_spread, zero_share, spread_min = self._reference_pass(answer["keep"],
                                                                                           answer["thumb"])
        out = numbers(answer["kept"], ref_kept, answer["thumbs"], ref_thumbs, thumb_spread)
        out.update(ref_zero_share=zero_share, ref_spread_min=spread_min)
        print(f"check: the reference clips {zero_share!r} of its pixels to 0; its smallest p95 - p5 spread is "
              f"{spread_min!r}", file=sys.stderr, flush=True)
        return out
