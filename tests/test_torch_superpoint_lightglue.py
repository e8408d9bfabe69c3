"""The port's learned VO frontend (models/superpoint.py, models/lightglue.py,
feature/learned.py, VoConfig(features="superpoint_lightglue")) against the
plain reference (benchmark/reference/plainsplg/superpoint_lightglue.py, the
one the splg-clip257 cell's check runs: functional PyTorch in float32 with
TF32 off, LightGlue on each pair's live keypoints as upstream's unpadded
path), at the published widths on weights drawn in upstream's layout
(`draw_state_dict`) and loaded with strict=True, on small inputs on the CPU
in float32:

  * SuperPoint on two 96x128 frames: the logits and the normalised coarse
    descriptors within 1e-5 (measured 0: the same convolutions in the same
    order), the NMS mask and the keypoints exactly, the keypoint
    descriptors within 1e-5 (measured 0);
  * LightGlue on 2 pairs of 64 slots, some dead: the log-assignment over
    the live rows and columns and the dustbins within 1.8e-6 of the
    largest entry's magnitude (measured 1.1e-4 at entries down to -193,
    5.5e-7 of it: the port's fused attention kernel against the
    written-out softmax, and its stacked batches, sum in other orders), its
    probabilities within 1e-5 (measured 3.4e-6), every dead row and column
    -inf, and the matches equal;
  * the state dict's layout, the old-key rename, the operation counts of
    benchmark/inputs/splg_counts.py against FlopCounterMode, and
    run_vo / run_vo_batched with the learned frontend, which refuse the
    mapping pipelines; the ORB path is the frozen reference's to the bit.

One `cuda` test (no JAX here: `python -m pytest --noconftest -m cuda
tests/test_torch_superpoint_lightglue.py` runs it on the GPU) runs the cell's
check on a 33-frame 1241x376 clip at 2048 keypoints, a 32-frame chunk, in
bfloat16 against the reference at the cell's limits, and reads the poses'
direction of travel against the scene's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, sdpa_flop_count

from benchmark import settings
from benchmark.inputs import scene as scene_mod
from benchmark.inputs import splg_counts
from benchmark.reference import plainslam
from benchmark.reference.plainsplg import superpoint_lightglue as plain
from slamtpu_torch.feature.learned import LearnedConfig, LearnedFrontend
from slamtpu_torch.models import superpoint as sp
from slamtpu_torch.odometry.camera import CameraIntrinsics
from slamtpu_torch.pipeline import depth_mapping, point_cloud, vo

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LIMITS = json.loads((ROOT / "benchmark" / "limits" / "splg-clip257.json").read_text())["limits"]
WEIGHTS = plain.draw_state_dict(2**31 + 5)
SMALL = LearnedConfig(max_keypoints=64)


def _frames(n: int, h: int, w: int, seed: int = 3) -> np.ndarray:
    cam = dict(fx=0.8 * w, fy=0.8 * w, cx=w / 2, cy=h / 2)
    return scene_mod.render(n, h, w, cam, 3000, 0.8, seed=seed, noise=2.0, textured=True).frames


def _frontend(config=SMALL, weights=WEIGHTS):
    return LearnedFrontend(weights["superpoint"], weights["lightglue"], config=config, device="cpu")


@pytest.fixture(scope="module")
def detected():
    frames = torch.from_numpy(_frames(3, 96, 128))
    fe = _frontend()
    feats, logits, descriptor_map = fe.detect(frames)
    return fe, frames, feats, logits, sp.normalize_descriptors(descriptor_map), plain.superpoint(WEIGHTS["superpoint"],
                                                                                             frames)


def test_superpoint_matches_the_reference(detected):
    _, frames, feats, logits, coarse, ref = detected
    for i, r in enumerate(ref):
        assert (logits[i] - r["logits"]).abs().max() <= 1e-5
        assert (coarse[i] - r["coarse"]).abs().max() <= 1e-5
    port_nms = sp.simple_nms(sp.keypoint_scores(logits), 4)
    ref_nms = plain.simple_nms(plain.keypoint_scores(torch.stack([r["logits"] for r in ref])), 4)
    assert torch.equal(port_nms > 0, ref_nms > 0)
    full = _frontend(LearnedConfig())  # 2048 slots: every candidate of a 96x128 frame, the rest dead
    all_feats, _, _ = full.detect(frames)
    for i, r in enumerate(ref):
        live = all_feats.mask[i]
        assert int(live.sum()) == len(r["keypoints"]) < 2048
        assert torch.equal(all_feats.xy[i][live], r["keypoints"][torch.argsort(r["scores"], descending=True,
                                                                              stable=True)])
        assert not all_feats.xy[i][~live].any() and not all_feats.scores[i][~live].any()
        order = {tuple(p): j for j, p in enumerate(r["keypoints"].tolist())}
        idx = torch.tensor([order[tuple(p)] for p in all_feats.xy[i][live].tolist()])
        assert (all_feats.descriptors[i][live] - r["descriptors"][idx]).abs().max() <= 1e-5
    # the 64-slot budget keeps the 64 best of the reference's selection
    for i, r in enumerate(ref):
        best = r["keypoints"][torch.topk(r["scores"], 64).indices]
        assert set(map(tuple, feats.xy[i].tolist())) == set(map(tuple, best.tolist()))


def test_a_frame_of_fewer_pixels_than_slots_keeps_every_slot():
    xy, scores, mask = sp.select_keypoints(torch.rand(2, 16, 24), 2048, 0.5, 4)
    assert tuple(xy.shape) == (2, 2048, 2) and tuple(mask.shape) == (2, 2048)
    assert 0 < int(mask.sum()) <= 2 * 8 * 16 and not xy[~mask].any() and not scores[~mask].any()


def _dead_masks(feats):
    mask = feats.mask.clone()
    mask[0, 50:] = False
    mask[1, 40:] = False
    mask[2, 60:] = False
    return mask


def test_lightglue_matches_the_reference_on_live_slots(detected):
    fe, _, feats, _, _, _ = detected
    mask = _dead_masks(feats)
    scores, matches0, _ = fe.match(feats.xy[:2], feats.descriptors[:2], mask[:2], feats.xy[1:], feats.descriptors[1:],
                                   mask[1:], (128, 96))
    k = SMALL.max_keypoints
    for i in range(2):
        m0, m1 = mask[i], mask[i + 1]
        ref = plain.lightglue(WEIGHTS["lightglue"], feats.xy[i][m0], feats.xy[i + 1][m1], feats.descriptors[i][m0],
                              feats.descriptors[i + 1][m1], (128, 96))
        idx0, idx1 = torch.nonzero(m0)[:, 0], torch.nonzero(m1)[:, 0]
        rows, cols = torch.cat([idx0, torch.tensor([k])]), torch.cat([idx1, torch.tensor([k])])
        live = scores[i][rows][:, cols]
        inner = ref["log_assignment"][:-1, :-1]
        assert (live - ref["log_assignment"]).abs().max() <= 1.8e-6 * inner.abs().max()
        assert (live.exp() - ref["log_assignment"].exp()).abs().max() <= 1e-5
        dead0, dead1 = torch.nonzero(~m0)[:, 0], torch.nonzero(~m1)[:, 0]
        assert torch.isneginf(scores[i][dead0]).all() and torch.isneginf(scores[i][:, dead1]).all()
        want = torch.full((k,), -1)
        want[idx0] = torch.where(ref["matches0"] >= 0, idx1[ref["matches0"].clamp(min=0)], -1)
        assert torch.equal(matches0[i], want) and int((want >= 0).sum()) > 10


def test_the_state_dicts_load_strictly_with_the_old_keys_renamed():
    fe = _frontend()
    assert set(fe.superpoint.state_dict()) == set(WEIGHTS["superpoint"])
    assert set(fe.lightglue.state_dict()) == set(WEIGHTS["lightglue"])
    assert sum(p.numel() for p in fe.superpoint.parameters()) == 1_300_865
    assert sum(p.numel() for p in fe.lightglue.parameters()) == 11_851_601
    def old_key(key: str) -> str:  # the published file's layout: self_attn.{i}.*, cross_attn.{i}.*
        if not key.startswith("transformers."):
            return key
        _, i, block, rest = key.split(".", 3)
        return f"{block}.{i}.{rest}"

    old = {old_key(k): v for k, v in WEIGHTS["lightglue"].items()}
    assert any(k.startswith("self_attn.8.") for k in old)
    renamed = _frontend(weights={"superpoint": WEIGHTS["superpoint"], "lightglue": old})
    for key, value in fe.lightglue.state_dict().items():
        assert torch.equal(renamed.lightglue.state_dict()[key], value), key
    with pytest.raises(RuntimeError):
        _frontend(weights={"superpoint": WEIGHTS["superpoint"],
                           "lightglue": {k: v for k, v in WEIGHTS["lightglue"].items() if "token_confidence" not in k}})


def _sdpa_cpu(query, key, value, *args, out_shape=None, **kwargs):
    return sdpa_flop_count(query, key, value)


@pytest.mark.parametrize("hw", [(96, 128), (100, 133)])
def test_the_operation_counts_are_the_flop_counters(detected, hw):
    fe = detected[0]
    with FlopCounterMode(display=False) as counter:
        fe.dense(torch.zeros((1, *hw), dtype=torch.uint8))
    assert counter.get_total_flops() == splg_counts.superpoint_flop(*hw)
    _, _, feats, _, _, _ = detected
    mapping = {torch.ops.aten._scaled_dot_product_flash_attention_for_cpu: _sdpa_cpu}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        fe.match(feats.xy[:1], feats.descriptors[:1], feats.mask[:1], feats.xy[1:2], feats.descriptors[1:2],
                 feats.mask[1:2], (128, 96))
    k = SMALL.max_keypoints
    assert counter.get_total_flops() == splg_counts.lightglue_flop(k)
    # the roofline's least work: the flash form's 4 products a layer less the cross block's second q k^T
    assert splg_counts.attention_flop(k) == 9 * (4 - 0.5) * sdpa_flop_count((2, 4, k, 64), (2, 4, k, 64),
                                                                           (2, 4, k, 64)) / 2
    assert round(splg_counts.lightglue_flop(2048) / 1e9, 1) == 249.1
    assert round(splg_counts.superpoint_flop(376, 1241) / 1e9, 2) == 79.11


CAMERA = CameraIntrinsics(180.0, 180.0, 100.0, 60.0)
CONFIG = vo.VoConfig(features="superpoint_lightglue",
                     ransac=vo.RansacConfig(iters=64, min_solver="5pt", octave_sigma=False))
LEARNED = LearnedConfig(max_keypoints=128)


@pytest.fixture(scope="module")
def clips():
    return np.stack([_frames(9, 120, 200, seed=11), _frames(9, 120, 200, seed=12)])


def test_run_vo_batched_equals_run_vo_with_the_learned_frontend(clips):
    fe = _frontend(LEARNED)
    batched = vo.run_vo_batched(clips, CAMERA, CONFIG, chunk_size=4, seed=5, device="cpu", frontend=fe)
    for b, clip in enumerate(clips):
        single = vo.run_vo(clip, CAMERA, CONFIG, chunk_size=4, seed=5 + b, device="cpu", frontend=fe)
        assert single.num_matches.min() > 20 and single.successful_frames >= 2
        for name in ("success", "is_keyframe", "num_matches", "num_inliers"):
            assert np.array_equal(getattr(single, name), getattr(batched[b], name)), name
        np.testing.assert_allclose(single.rotations, batched[b].rotations, atol=1e-5)


def test_run_vo_keeps_what_is_asked_and_refuses_what_it_cannot_run(clips):
    fe = _frontend(LEARNED)
    run = vo.run_vo(clips[0], CAMERA, CONFIG, chunk_size=4, seed=5, device="cpu", frontend=fe, keep=[3, 0])
    assert run.kept["pairs"] == [0, 3] and sorted(run.kept["frames"]) == [0, 1, 3, 4]
    assert tuple(run.kept["assign"][3]["log_assignment"].shape) == (129, 129)
    assert [start for start, *_ in run.kept["pose_inputs"]] == [0, 4, 8]
    good = torch.cat([g for *_, g in run.kept["pose_inputs"]])[1:]
    assert np.array_equal(good.sum(-1).numpy(), run.num_matches)
    assert vo.run_vo(clips[0], CAMERA, CONFIG, chunk_size=4, seed=5, device="cpu", frontend=fe).kept is None
    with pytest.raises(ValueError, match="frontend"):
        vo.run_vo(clips[0], CAMERA, CONFIG, device="cpu")
    with pytest.raises(ValueError, match="keep"):
        vo.run_vo(clips[0], CAMERA, vo.VoConfig(), device="cpu", keep=[1])
    with pytest.raises(ValueError, match="ORB frontend only"):
        point_cloud.run_point_cloud_fused(clips[0], CAMERA, point_cloud.PointCloudConfig(vo=CONFIG), device="cpu")
    with pytest.raises(ValueError, match="ORB frontend only"):
        depth_mapping.run_depth_mapping(clips[0], CAMERA, lambda f: np.ones(f.shape), vo_config=CONFIG, device="cpu")


def test_the_orb_path_is_the_frozen_references_to_the_bit(clips):
    from benchmark import programs

    ref = programs.reference()
    clip = clips[0]
    port_run = vo.run_vo(clip, CAMERA, vo.VoConfig(), chunk_size=4, seed=9, device="cpu")
    ref_run = ref.run_vo(clip, ref.CameraIntrinsics(180.0, 180.0, 100.0, 60.0), ref.VoConfig(), chunk_size=4, seed=9,
                         device="cpu")
    assert plainslam.__name__ == "benchmark.reference.plainslam"
    for name in ("success", "is_keyframe", "num_matches", "num_inliers", "rotations", "translations"):
        assert np.array_equal(getattr(port_run, name), getattr(ref_run, name)), name
    assert settings.build(vo.VoConfig, settings.config_file(settings.spec(), "kitti-vo")["vo"]) == vo.VoConfig()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU with -m cuda)")
    return "cuda"


@pytest.mark.cuda
def test_the_cells_check_on_the_card_at_2048_keypoints(cuda):
    spec = settings.spec()
    cell = settings.cell(spec, "splg-clip257")
    config = settings.config_file(spec, cell["config"])
    traffic = dict(settings.traffic_file(cell["traffic"]), clip_frames=33)
    traffic["scene"] = dict(traffic["scene"], frames=33)
    scene = scene_mod.render(33, 376, 1241, config["camera"], 4000, 0.8, seed=2**31 + 9, noise=2.0, textured=True)
    driver = settings.load_module("drivers", "splg_clip").Driver(config, traffic, scene, 2**31 + 9, cuda)
    answer = driver.request(0)["answer"]
    assert driver.frontend.compute_dtype == torch.bfloat16
    # the drawn detector's keypoints are the scene's blob peaks: several hundred of the 2048 slots
    live = [int(f["mask"].sum()) for f in answer["kept"]["frames"].values()]
    print(f"live slots of the kept frames: {live}")
    assert all(100 < n < 2048 for n in live)
    numbers = driver.check(answer)
    print(f"the cell's check on 33 frames: {numbers}")
    assert all(numbers[k] <= LIMITS[k] for k in LIMITS), numbers
    assert numbers["gt_dir_err_p50_deg"] < 10.0  # the matches are the scene's: the poses follow its drive
