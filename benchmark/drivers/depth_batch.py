"""Batches of frames through the port's `MonoDepth2.predict_raw`, one pass
over the scene's frames a request (a closed loop with one client): the
frames go in as host uint8 grayscale, in an order permuted from the run's
seed and the request, in calls of the mix's batch (the last one shorter
where the frames do not split), and each call's float32 disparity is
fetched to the host before the next call. The weights are
drawn from the seed in upstream's checkpoint layout and loaded through
`MonoDepth2(encoder=..., decoder=...)`.

A request keeps a small answer: a few whole frames drawn from the seed and
the request, and an average-pooled thumbnail of every frame. The check runs
the plain reference (benchmark/reference/plaindepth, float32, TF32 off) over
the same frames in blocks and reads:

  disp_gap_max      the largest |port - reference| over the kept frames;
  disp_rel_rms_max  per kept frame, the rms of the gap over the reference's
                    standard deviation, the largest;
  thumb_gap_max     the largest gap over every frame's thumbnail;
  ref_spread_min    (a reading, not a limit) the reference's smallest p95 -
                    p5 disparity spread over the kept frames;
  ref_saturated     (a reading, not a limit) the share of the kept frames'
                    reference pixels within 0.01 of 0 or 1, where the
                    sigmoid has saturated.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.plaindepth import monodepth2 as plain

def port_program(encoder_sd: dict, decoder_sd: dict, model: dict, device):
    """The port's MonoDepth2 as the depth CLI builds it."""
    from slamtpu_torch.depth.monodepth2 import MonoDepth2

    return MonoDepth2(encoder=encoder_sd, decoder=decoder_sd, width=model["width"], height=model["height"],
                      compute_dtype=getattr(torch, model["compute_dtype"]), device=device)


def reference_program(encoder_sd: dict, decoder_sd: dict, model: dict, device):
    """The plain reference, float32."""
    return plain.PlainMonoDepth2(encoder_sd, decoder_sd, model["width"], model["height"], device)


def _thumbnails(disp: torch.Tensor, pool: int) -> torch.Tensor:
    # The network has no average pooling, so this kernel is the driver's
    # alone: benchmark/inputs/depth_counts.py classes it apart.
    return F.avg_pool2d(disp[:, None], pool)[:, 0]


def _numbers(port_kept, ref_kept, port_thumbs, ref_thumbs) -> dict:
    """The compared numbers of one answer against the reference's."""
    gap = np.abs(port_kept.astype(np.float64) - ref_kept)
    rms = np.sqrt((gap ** 2).mean(axis=(1, 2)))
    std = ref_kept.reshape(len(ref_kept), -1).std(axis=1)
    p5, p95 = np.percentile(ref_kept.reshape(len(ref_kept), -1), [5, 95], axis=1)
    return dict(disp_gap_max=float(gap.max()), disp_rel_rms_max=float(np.max(rms / np.maximum(std, 1e-12))),
                thumb_gap_max=float(np.abs(port_thumbs.astype(np.float64) - ref_thumbs).max()),
                ref_spread_min=float(np.min(p95 - p5)),
                ref_saturated=float(np.mean((ref_kept < 0.01) | (ref_kept > 0.99))))


class Driver:
    def __init__(self, config: dict, traffic: dict, scene, seed: int, device, program=None):
        self.model_cfg, self.traffic, self.seed, self.device = config["model"], traffic, int(seed), device
        self.frames = scene.frames  # [N, H, W] host uint8, as a user holds decoded frames
        self.batch = int(traffic["batch"])
        self.pool, self.n_keep = int(traffic["thumbnail_pool"]), int(traffic["keep_frames"])
        self.weights = plain.draw_state_dicts(self.seed)
        self.model = (program or port_program)(*self.weights, self.model_cfg, device)
        self.block = np.empty((self.batch, *self.frames.shape[1:]), np.uint8)
        self._reference = {}

    def _order(self, i: int):
        """The request's frame order and its kept frames (sorted)."""
        rng = np.random.default_rng([self.seed, int(i) + 1])
        n = len(self.frames)
        return rng.permutation(n), np.sort(rng.choice(n, self.n_keep, replace=False))

    def request(self, i: int) -> dict:
        order, keep = self._order(i)
        h, w = self.model_cfg["height"], self.model_cfg["width"]
        thumbs = np.empty((len(self.frames), h // self.pool, w // self.pool), np.float32)
        kept = np.empty((len(keep), h, w), np.float32)
        where = {int(f): k for k, f in enumerate(keep)}
        for start in range(0, len(order), self.batch):
            idx = order[start : start + self.batch]
            block = self.block[: len(idx)]  # the last call is shorter where the frames do not split
            np.take(self.frames, idx, axis=0, out=block, mode="clip")  # unbuffered; idx is in range
            disp = self.model.predict_raw(block)  # [len(idx), h, w] float32 on the device
            with torch.no_grad():
                thumb = _thumbnails(disp, self.pool)
            host = disp.cpu().numpy()
            thumbs[idx] = thumb.cpu().numpy()
            for j, f in enumerate(idx.tolist()):
                if f in where:
                    kept[where[f]] = host[j]
        return dict(frames=len(order), detected=order.tolist(), answer=dict(keep=keep, kept=kept, thumbs=thumbs))

    def warmup(self) -> None:
        self.request(-1)

    def _reference_pass(self, keep) -> tuple:
        """The reference's kept frames and thumbnails, over the scene in
        blocks of the mix's `check_block` frames."""
        key = tuple(int(f) for f in keep)
        if key not in self._reference:
            ref = reference_program(*self.weights, self.model_cfg, self.device)
            step = int(self.traffic["check_block"])
            thumbs, kept = [], {}
            for start in range(0, len(self.frames), step):
                disp = ref.predict_raw(self.frames[start : start + step])
                thumbs.append(_thumbnails(disp, self.pool).cpu().numpy())
                for f in key:
                    if start <= f < start + step:
                        kept[f] = disp[f - start].cpu().numpy()
            self._reference = {key: (np.stack([kept[f] for f in key]), np.concatenate(thumbs))}
        return self._reference[key]

    def check(self, answer, reference=None) -> dict:
        """The compared numbers; `reference` (the VO programs' namespace the
        harness passes) is not used."""
        ref_kept, ref_thumbs = self._reference_pass(answer["keep"])
        out = _numbers(answer["kept"], ref_kept, answer["thumbs"], ref_thumbs)
        print(f"check: reference disparity spread p95 - p5 >= {out['ref_spread_min']!r} over the kept frames, "
              f"{out['ref_saturated']!r} of their pixels saturated", file=sys.stderr, flush=True)
        return out
