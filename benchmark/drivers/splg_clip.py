"""Whole clips through `run_vo` with the learned frontend (SuperPoint +
LightGlue, `VoConfig(features="superpoint_lightglue")`), one clip a request
(a closed loop with one client). Every request sends the same frames with
its own RANSAC seed. The weights are drawn from the seed in upstream's
layout (benchmark/reference/plainsplg/superpoint_lightglue.py::draw_state_dict)
and loaded with strict=True through `LearnedFrontend`.

A request keeps, on the device, what each stage made for `keep_pairs`
pairs drawn from (seed, request) and every pair's correspondences
(`run_vo(keep=...)`, `VoRun.kept`), each log-assignment cut to its live
rows and columns (`live_block`). The check fetches them and recomputes
each stage with the plain references (float32, TF32 off) on the port's own
inputs, so that a selection flipped upstream does not spread:

  sp_logit_gap_rel_max  SuperPoint on each kept frame: the largest gap of
                        the 65-channel logits over the reference's standard
                        deviation;
  sp_desc_cos_gap_max   the largest 1 - cosine of the normalised coarse
                        descriptor maps, and of the port's keypoint descriptors
                        against the reference's sampling of its own coarse
                        map at the port's keypoints;
  kp_miss_max           the largest share of a frame's live keypoints that
                        the reference's own selection (NMS, border,
                        threshold, top 2048) does not hold;
  lg_prob_gap_max       LightGlue (the reference on the port's live
                        keypoints and descriptors) on each kept pair: the
                        largest gap of exp(log-assignment) over the live
                        rows and columns and the dustbins;
  lg_rel_rms_max        the rms gap of the inner block over the
                        reference's standard deviation, the largest;
  lg_match_miss_max     the largest share of the reference's matches that
                        the port does not give;
  pose_off_share        the pose stage (benchmark/reference/plainslam) on
                        the port's correspondences of every pair, with the
                        request's draws and chunks, against the port's
                        poses, as vo-clip257 reads it (compare.pairs).

Readings, not limits (with drawn weights they say whether the matches mean
something, not whether the port is right), returned beside them and
printed: gt_fail_share, gt_rot_err_p50_deg and gt_dir_err_p50_deg (the
direction of travel) against the scene's ground truth, the median matches
a pair and the median inlier share.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark import compare, programs, settings
from benchmark.reference.plainslam.odometry.camera import CameraIntrinsics as RefIntrinsics
from benchmark.reference.plainslam.odometry.pose import estimate_relative_pose
from benchmark.reference.plainslam.ops import ransac as ref_ransac
from benchmark.reference.plainsplg import superpoint_lightglue as plain

LIMITS = ("sp_logit_gap_rel_max", "sp_desc_cos_gap_max", "kp_miss_max", "lg_prob_gap_max", "lg_rel_rms_max",
          "lg_match_miss_max", "pose_off_share")


def port_frontend(weights: dict, model: dict, device):
    """The port's LearnedFrontend of the drawn weights (bfloat16 on CUDA)
    with the settings of the configuration's model block."""
    from slamtpu_torch.feature.learned import LearnedConfig, LearnedFrontend

    sp, lg = model["superpoint"], model["lightglue"]
    config = LearnedConfig(max_keypoints=sp["max_num_keypoints"], descriptor_dim=sp["descriptor_dim"],
                           nms_radius=sp["nms_radius"], detection_threshold=sp["detection_threshold"],
                           remove_borders=sp["remove_borders"], n_layers=lg["n_layers"], num_heads=lg["num_heads"],
                           filter_threshold=lg["filter_threshold"])
    return LearnedFrontend(weights["superpoint"], weights["lightglue"], config=config, device=device)


def _miss(port_kp: np.ndarray, ref_kp: np.ndarray, width: int) -> float:
    """The share of the port's keypoints (integer pixels) not among the
    reference's."""
    if not len(port_kp):
        return 0.0
    code = lambda kp: kp[:, 1].astype(np.int64) * width + kp[:, 0].astype(np.int64)  # noqa: E731
    return float(1.0 - np.isin(code(port_kp), code(ref_kp)).mean())


def superpoint_numbers(frame: dict, ref: dict, width: int) -> dict:
    """One kept frame (the port's logits, coarse descriptor map and
    features) against the reference's SuperPoint on the same frame."""
    logits, ref_logits = frame["logits"].float(), ref["logits"]
    live = frame["mask"]
    kp, desc = frame["xy"][live], frame["descriptors"][live].float()
    cos_coarse = (plain.normalize_descriptors(frame["descriptor_map"].float()[None])[0] * ref["coarse"]).sum(0)
    cos_kp = (torch.nn.functional.normalize(desc, dim=-1) * plain.sample_descriptors(kp, ref["coarse"][None])).sum(-1)
    return dict(sp_logit_gap_rel_max=float((logits - ref_logits).abs().max() / ref_logits.std()),
                sp_desc_cos_gap_max=float(max((1 - cos_coarse).max(), (1 - cos_kp).max() if len(kp) else 0.0)),
                kp_miss_max=_miss(kp.cpu().numpy(), ref["keypoints"].cpu().numpy(), width))


def lightglue_numbers(f0: dict, f1: dict, assign: dict, lightglue_sd: dict, size: tuple, conf: dict) -> dict:
    """One kept pair: the port's log-assignment over the live slots and the
    dustbins (`live_block`) and its matches against the reference's
    LightGlue on the port's live keypoints and descriptors."""
    m0, m1 = f0["mask"], f1["mask"]
    idx0, idx1 = torch.nonzero(m0)[:, 0], torch.nonzero(m1)[:, 0]
    ref = plain.lightglue(lightglue_sd, f0["xy"][m0], f1["xy"][m1], f0["descriptors"][m0].float(),
                          f1["descriptors"][m1].float(), size, conf)
    port = assign["log_assignment"].float()
    ref_la = ref["log_assignment"]
    inner, ref_inner = port[:-1, :-1], ref_la[:-1, :-1]
    rms = float(((inner - ref_inner) ** 2).mean().sqrt() / ref_inner.std()) if inner.numel() > 1 else 0.0
    ref_m0 = ref["matches0"]
    matched = ref_m0 >= 0
    port_m0 = assign["matches0"][idx0]
    miss = float((port_m0[matched] != idx1[ref_m0[matched]]).float().mean()) if bool(matched.any()) else 0.0
    return dict(lg_prob_gap_max=float((port.exp() - ref_la.exp()).abs().max()), lg_rel_rms_max=rms,
                lg_match_miss_max=miss)


def live_block(kept: dict) -> dict:
    """`kept` with each pair's [K+1, K+1] log-assignment cut to its live
    rows and columns and the dustbins, [n0 + 1, n1 + 1]: the rest is -inf
    by construction and the check reads only this."""
    assign = {}
    for p, a in kept["assign"].items():
        rows, cols = (torch.cat([torch.nonzero(kept["frames"][f]["mask"])[:, 0],
                                 torch.tensor([a["log_assignment"].shape[0] - 1], device=a["log_assignment"].device)])
                      for f in (p, p + 1))
        assign[p] = dict(a, log_assignment=a["log_assignment"][rows][:, cols])
    return dict(kept, assign=assign)


class Driver:
    def __init__(self, config: dict, traffic: dict, scene, seed: int, device, program=None):
        self.prog = programs.port()
        self.config, self.traffic, self.seed, self.device = config, traffic, int(seed), device
        n = traffic["clip_frames"]
        self.frames = scene.frames[:n]  # host uint8, as a user holds decoded frames
        self.gt = compare.relative_rotations(scene.rotations[:n])
        t = np.asarray(scene.translations[:n], np.float64)
        self.gt_dir = t[1:] - np.einsum("nij,nj->ni", self.gt, t[:-1])  # p_next = R p + t
        self.vo = settings.build(self.prog.VoConfig, config["vo"])
        self.camera = self.prog.CameraIntrinsics(**config["camera"])
        self.weights = plain.draw_state_dict(self.seed)
        self.frontend = (program or port_frontend)(self.weights, config["model"], device)
        self.ref_weights = {net: {k: v.to(device) for k, v in sd.items()} for net, sd in self.weights.items()}
        model = config["model"]  # the reference's settings are the configuration's
        self.sp_conf = {k: model["superpoint"][k] for k in plain.SP}
        self.lg_conf = {k: model["lightglue"][k] for k in plain.LG}

    def keep(self, i: int) -> list:
        """The request's kept pairs, drawn from (seed, request)."""
        rng = np.random.default_rng([self.seed, int(i) + 1, 0x4B])
        return sorted(rng.choice(len(self.frames) - 1, self.traffic["keep_pairs"], replace=False).tolist())

    def request(self, i: int) -> dict:
        s = programs.request_seed(self.seed, i)
        run = self.prog.run_vo(self.frames, self.camera, self.vo, chunk_size=self.traffic["chunk_size"], seed=s,
                               device=self.device, frontend=self.frontend, keep=self.keep(i))
        n = len(self.frames)
        # ~38 MB stay on the card until the check: on an H100, keeping them
        # costs ~2 % of a request, taking them to the host 3-6 %.
        answer = dict(seed=s, vo=programs.vo_answer(run), kept=live_block(run.kept),
                      num_matches=np.asarray(run.num_matches),
                      num_inliers=np.asarray(run.num_inliers))
        return dict(frames=n, detected=list(range(n)), answer=answer)

    def warmup(self) -> None:
        self.request(-1)

    def _reference_poses(self, seed: int, pose_inputs) -> dict:
        """The reference's pose stage on the port's correspondences, chunk by
        chunk as run_vo ran them, the masked seed step dropped."""
        cfg = settings.build(ref_ransac.RansacConfig, self.config["vo"]["ransac"])
        cam = RefIntrinsics(**self.config["camera"])
        parts = []
        for start, pts1, pts2, good in pose_inputs:
            steps = [max(start + j - 1, 0) for j in range(pts1.shape[0])]
            draws = ref_ransac.pair_draws(seed, steps, cfg, pts1.shape[1], pts1.device)
            poses = estimate_relative_pose(cam, pts1, pts2, mask=good, config=cfg, sigma=torch.ones_like(pts1[..., 0]),
                                           uniforms=draws)
            enough = torch.sum(good, dim=-1) >= self.vo.min_matches
            step_ok = torch.tensor([start + j >= 1 for j in range(len(steps))], device=pts1.device)
            parts.append((poses.valid & enough & step_ok, poses.rotation, poses.translation))
        success, rotations, translations = (torch.cat(x)[1:].cpu().numpy() for x in zip(*parts))
        return dict(success=success.astype(bool), rotations=rotations, translations=translations)

    def check(self, answer, reference=None) -> dict:
        """The compared numbers and the readings; `reference` (the VO
        programs' namespace the harness passes) is not used: the pose
        stage's reference is plainslam's, imported here."""
        kept = answer["kept"]
        h, w = self.frames.shape[1:]
        with torch.no_grad():
            order = sorted(kept["frames"])
            frames = torch.as_tensor(self.frames[order]).to(self.device)
            ref_sp = plain.superpoint(self.ref_weights["superpoint"], frames, self.sp_conf)
            sp_parts = [superpoint_numbers(kept["frames"][f], r, w) for f, r in zip(order, ref_sp)]
            lg_parts = [lightglue_numbers(kept["frames"][p], kept["frames"][p + 1], kept["assign"][p],
                                          self.ref_weights["lightglue"], (w, h), self.lg_conf) for p in kept["pairs"]]
            ref_poses = self._reference_poses(answer["seed"], kept["pose_inputs"])
        out = {**compare.worst(sp_parts), **compare.worst(lg_parts), **compare.pairs(answer["vo"], ref_poses)}
        vo = answer["vo"]
        matches = answer["num_matches"]
        has = matches > 0
        ok = np.asarray(vo["success"], bool)
        readings = dict(**compare.ground_truth(vo["success"], vo["rotations"], self.gt),
                        gt_dir_err_p50_deg=float(np.median(compare.direction_gap_deg(vo["translations"][ok],
                                                                                      self.gt_dir[ok])))
                        if ok.any() else 180.0,
                        matches_p50=float(np.median(matches)),
                        inlier_share_p50=float(np.median(answer["num_inliers"][has] / matches[has])) if has.any()
                        else 0.0)
        print(f"check: readings {readings}", file=sys.stderr, flush=True)
        return {**out, **readings}
