"""The VO options of the port against the JAX package, on the same seeded
inputs and the same draws: the IRLS refit, prescore, continuously steered
BRIEF (the detector's `descriptor_bins=0`), `run_vo` with the homography
fallback, `VoConfig.robust()`, and `run_vo_batched`.

Tolerances. RANSAC at f64 (IRLS, prescore): inlier sets and counts exact,
essential matrices within 1e-8 (tests/test_torch_two_view.py's regime).
Descriptors: tests/test_torch_detector.py's bar, with the continuous
path's own rounding ties (a rotated pattern coordinate within 1e-3 of a
half pixel). Whole runs in f32 against the JAX package: matches exact, and
tests/test_torch_vo.py's bars (inlier counts and flags exact, rotations
within 0.1 degree) on every pair but those where rounding elects another
five-point winner (ROADMAP A1), which are held at f64 instead
(`_assert_runs_agree`). `run_vo_batched` against the
port's own `run_vo` per sequence: tests/test_vo_pipeline.py's bars
(success, matches and keyframes equal, rotations within 1e-5).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.feature import detector as jdet
from slamtpu.io.synthetic import render_sequence as j_render
from slamtpu.ops import brief as jbrief
from slamtpu.ops import ransac as jransac
from slamtpu.odometry.camera import CameraIntrinsics as JCam
from slamtpu.odometry.pose import estimate_relative_pose as j_pose
from slamtpu.ops.ransac import RansacConfig as JRansacConfig
from slamtpu.pipeline import vo as jvo
from slamtpu_torch import convert
from slamtpu_torch.feature import detector as tdet
from slamtpu_torch.feature.matcher import FeatureMatcher
from slamtpu_torch.io.synthetic import render_sequence as t_render
from slamtpu_torch.odometry.pose import estimate_relative_pose as t_pose
from slamtpu_torch.ops.patch_refine import refine_matches
from slamtpu_torch.ops import brief as tbrief
from slamtpu_torch.ops import ransac as transac
from slamtpu_torch.ops.ransac import PairDraws
from slamtpu_torch.pipeline import vo as tvo

from test_torch_detector import texture
from test_torch_two_view import two_view

torch.set_num_threads(1)

SCENE = dict(n_frames=8, height=160, width=200, n_points=600, step=0.3, seed=3, textured=True)
ORB = dict(max_features=96, n_levels=4)
ITERS = 16


def _angle_deg(a, b):
    tr = np.einsum("...ij,...ij->...", np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def _ransac_both(rng, cfg_j, n=150, key=0):
    """Both packages' ransac_essential at f64 on one scene with outliers and
    per-octave sigma, on the JAX draws (essential: uniform(key); prescore:
    uniform(fold_in(key, 1)))."""
    p1, p2, _, _ = two_view(rng, n, noise=1e-3, outliers=0.25)
    mask = rng.uniform(size=n) > 0.1
    sigma = 1.2 ** rng.integers(0, 3, n).astype(np.float64)
    k = jax.random.PRNGKey(key)
    ref = jransac.ransac_essential(k, jnp.asarray(p1), jnp.asarray(p2), mask=jnp.asarray(mask),
                                   threshold_norm=2e-3, config=cfg_j, sigma=jnp.asarray(sigma))
    draws = PairDraws(torch.from_numpy(np.asarray(jax.random.uniform(k, (cfg_j.iters, n), dtype=jnp.float32))),
                      prescore=torch.from_numpy(np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (n,),
                                                                              dtype=jnp.float32))))
    cfg = convert._convert(transac.RansacConfig, cfg_j)
    ours = transac.ransac_essential(torch.from_numpy(p1), torch.from_numpy(p2), mask=torch.from_numpy(mask),
                                    threshold_norm=2e-3, config=cfg, sigma=torch.from_numpy(sigma), uniforms=draws)
    return ours, ref


def _same_up_to_sign(a, b, atol):
    sign = np.sign(np.sum(a * b))
    np.testing.assert_allclose(a * sign, b, rtol=0, atol=atol)


@pytest.mark.parametrize("min_solver", ["8pt", "5pt"])
def test_irls_refit_matches_jax(rng, min_solver):
    cfg_j = JRansacConfig(iters=64, min_solver=min_solver, refit_method="irls")
    ours, ref = _ransac_both(rng, cfg_j)
    assert int(ours.best_iter_inliers) == int(ref.best_iter_inliers)
    assert int(ours.num_inliers) == int(ref.num_inliers) > 60
    np.testing.assert_array_equal(ours.inliers.numpy(), np.asarray(ref.inliers))
    _same_up_to_sign(ours.essential.numpy(), np.asarray(ref.essential), 1e-8)


@pytest.mark.parametrize("subset", [40, 500])
def test_prescore_matches_jax(rng, subset):
    """Stage-1 scoring on a 40-row subset (and a subset as large as the
    rows, where stage 1 is off in both)."""
    cfg_j = JRansacConfig(iters=32, min_solver="5pt", prescore_subset=subset)
    ours, ref = _ransac_both(rng, cfg_j, key=3)
    assert int(ours.best_iter_inliers) == int(ref.best_iter_inliers)
    assert int(ours.num_inliers) == int(ref.num_inliers) > 60
    np.testing.assert_array_equal(ours.inliers.numpy(), np.asarray(ref.inliers))
    _same_up_to_sign(ours.essential.numpy(), np.asarray(ref.essential), 1e-8)


def _rounding_ties(angles, c=19):
    """[K, 256] True where a rotated pattern coordinate of either endpoint
    lies within 1e-3 of a half pixel (its rounding decided by an ulp)."""
    pat = tbrief.brief_pattern().astype(np.float64)
    cos, sin = np.cos(angles)[:, None], np.sin(angles)[:, None]
    near = np.zeros((len(angles), 256), bool)
    for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
        for v in (px * cos - py * sin, px * sin + py * cos):
            near |= np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-3
    return near


def test_continuous_brief_matches_jax(rng):
    frames = np.stack([texture(rng, 120, 200) for _ in range(2)]).astype(np.float32)
    ys, xs = rng.integers(0, 120 - 39, 80), rng.integers(0, 200 - 39, 80)
    patches = np.stack([frames[i % 2, y : y + 39, x : x + 39] for i, (y, x) in enumerate(zip(ys, xs))])
    angles = rng.uniform(-math.pi, math.pi, 80).astype(np.float32)
    ours = tbrief.brief_descriptors(torch.from_numpy(patches), torch.from_numpy(angles)).numpy()
    ref = np.asarray(jbrief.brief_descriptors(jnp.asarray(patches), jnp.asarray(angles)))
    differ = np.unpackbits(ours, axis=-1, bitorder="little") != np.unpackbits(ref, axis=-1, bitorder="little")
    assert not (differ & ~_rounding_ties(angles)).any()
    assert differ.sum() <= 2


@pytest.mark.parametrize("seed", [0, 1])
def test_detector_continuous_brief_matches_jax(seed):
    """descriptor_bins=0: orientation on the raw levels' windows, BRIEF on
    the blurred ones (one K2 launch for both on the card), against the JAX
    detector, at tests/test_torch_detector.py's bar."""
    rng = np.random.default_rng(seed)
    frames = np.stack([texture(rng, 120, 200) for _ in range(2)])
    ref = jdet.detect_and_compute(jnp.asarray(frames), jdet.OrbConfig(max_features=64, n_levels=4, descriptor_bins=0))
    ours = tdet.detect_and_compute(torch.from_numpy(frames), tdet.OrbConfig(max_features=64, n_levels=4,
                                                                            descriptor_bins=0))
    mask = np.asarray(ref.mask)
    np.testing.assert_array_equal(ours.mask.numpy(), mask)
    assert mask.sum() > 60
    np.testing.assert_allclose(ours.xy.numpy(), np.asarray(ref.xy), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours.angle.numpy(), np.asarray(ref.angle), atol=1e-4)
    differ = np.unpackbits(ours.descriptors.numpy(), axis=-1, bitorder="little") != np.unpackbits(
        np.asarray(ref.descriptors), axis=-1, bitorder="little")
    differ &= mask[..., None]
    if differ.any():
        ties = _rounding_ties(ours.angle.numpy().reshape(-1)).reshape(differ.shape)
        assert not (differ & ~ties).any(), "descriptor bits differ without a rounding tie"
    assert differ.sum() <= 2


@pytest.fixture(scope="module")
def clip():
    return t_render(**SCENE), j_render(**SCENE)


def _jax_cfg(**ransac):
    return jvo.VoConfig(orb=jdet.OrbConfig(**ORB), ransac=JRansacConfig(iters=ITERS, min_solver="5pt", **ransac))


def _uniform(keys, shape):
    return torch.from_numpy(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape, dtype=jnp.float32))(keys)))


def _jax_draws(keys, jcfg) -> PairDraws:
    """The JAX package's draws of each pair's key: with the fallback on,
    the essential and homography streams of split(key)."""
    k = jcfg.orb.max_features
    if not jcfg.ransac.homography_fallback:
        return PairDraws(_uniform(keys, (jcfg.ransac.iters, k)))
    k_e, k_h = jax.vmap(jax.random.split, out_axes=1)(keys)
    return PairDraws(_uniform(k_e, (jcfg.ransac.iters, k)), _uniform(k_h, (jcfg.ransac.homography_iters, k)))


def _assert_runs_agree(ours, ref, frames, cam, jcfg, keys, draws):
    """A run of the port against the JAX package's on its draws. Matching
    is exact. The f32 pose step may differ where rounding elects another
    five-point winner (ROADMAP A1), so each pair whose success, inlier
    count or rotation (0.1 degree, tests/test_torch_vo.py's bar) differs
    is re-solved at f64 by both packages on the port's correspondences
    and the pair's draws, where they must agree: validity and inlier count
    exact, rotation within 1e-8. Such pairs stay a minority of the run."""
    np.testing.assert_array_equal(ours.num_matches, ref.num_matches)
    rot = _angle_deg(ours.rotations, ref.rotations)
    differ = (ours.num_inliers != ref.num_inliers) | (ours.success != ref.success) | (rot > 0.1)
    assert differ.sum() <= len(differ) // 4, np.nonzero(differ)
    np.testing.assert_array_equal(ours.is_keyframe[~differ], ref.is_keyframe[~differ])
    cfg = convert.config_from_jax(jcfg)
    jcam = JCam(cam.fx, cam.fy, cam.cx, cam.cy)
    matcher = FeatureMatcher()
    for i in np.nonzero(differ)[0]:
        feats = tdet.detect_and_compute(torch.from_numpy(frames[i : i + 2]), cfg.orb)
        good = matcher.filter_good_matches(matcher.match_descriptors(
            feats.descriptors[0], feats.descriptors[1], feats.mask[0], feats.mask[1]), cfg.match_ratio)
        p1, p2 = feats.xy[0], feats.xy[1][good.train_idx]
        if cfg.refine_matches:
            p2 = refine_matches(torch.from_numpy(frames[i]), torch.from_numpy(frames[i + 1]), p1, p2, good.mask,
                                radius=cfg.refine_radius, search=cfg.refine_search)
        sigma = cfg.orb.scale_factor ** torch.maximum(feats.octave[0], feats.octave[1][good.train_idx]).double()
        p1, p2 = p1.double(), p2.double()
        j = j_pose(keys[i], jcam, jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy()), mask=jnp.asarray(good.mask.numpy()),
                   config=jcfg.ransac, sigma=jnp.asarray(sigma.numpy()))
        t = t_pose(cam, p1, p2, mask=good.mask, config=cfg.ransac, sigma=sigma,
                   uniforms=PairDraws(*[None if d is None else d[i] for d in draws]))
        assert (bool(t.valid), int(t.num_inliers)) == (bool(j.valid), int(j.num_inliers)), i
        np.testing.assert_allclose(t.rotation.numpy(), np.asarray(j.rotation), rtol=0, atol=1e-8, err_msg=str(i))


def test_run_vo_with_homography_fallback_matches_jax(clip):
    """The fallback's two streams come from split(key) of each pair's key,
    as in the JAX package (which splits only while the fallback is on)."""
    scene, jscene = clip
    jcfg = _jax_cfg(homography_fallback=True, homography_iters=32)
    ref = jvo.run_vo(jscene.frames, jscene.intrinsics, jcfg, chunk_size=4, seed=0)
    keys = jax.random.split(jax.random.PRNGKey(0), SCENE["n_frames"] - 1)
    draws = _jax_draws(keys, jcfg)
    ours = tvo.run_vo(scene.frames, scene.intrinsics, convert.config_from_jax(jcfg), chunk_size=4, uniforms=draws,
                      device="cpu", pose_dtype=torch.float64)
    _assert_runs_agree(ours, ref, scene.frames, scene.intrinsics, jcfg, keys, draws)
    assert ref.success.sum() >= SCENE["n_frames"] - 2


def test_robust_preset_and_config_fields():
    assert convert.config_from_jax(jvo.VoConfig.robust()) == tvo.VoConfig.robust()
    assert tvo.VoConfig.robust().ransac.iters == 256
    j = dataclasses.replace(jvo.VoConfig(), refine_matches=True, refine_radius=3, refine_search=1)
    assert convert.config_from_jax(j) == tvo.VoConfig(refine_matches=True, refine_radius=3, refine_search=1)


def test_run_vo_batched_equals_run_vo_and_jax(clip):
    """Two windows of the clip in one pass: each equals the port's run_vo
    of its window at seed + b, and, on the JAX draws, the JAX
    run_vo_batched (sequence b on split(PRNGKey(seed + b)))."""
    scene, jscene = clip
    jcfg = _jax_cfg()
    cfg = convert.config_from_jax(jcfg)
    windows = np.stack([scene.frames[:6], scene.frames[2:]])
    runs = tvo.run_vo_batched(windows, scene.intrinsics, cfg, chunk_size=4, seed=5, device="cpu")
    assert len(runs) == 2
    for b in range(2):
        solo = tvo.run_vo(windows[b], scene.intrinsics, cfg, chunk_size=4, seed=5 + b, device="cpu")
        for name in ("success", "num_matches", "is_keyframe", "num_inliers"):
            np.testing.assert_array_equal(getattr(runs[b], name), getattr(solo, name), err_msg=name)
        np.testing.assert_allclose(runs[b].rotations, solo.rotations, rtol=0, atol=1e-5)
        assert len(runs[b].trajectory) == len(solo.trajectory)

    ref = jvo.run_vo_batched(np.stack([jscene.frames[:6], jscene.frames[2:]]), jscene.intrinsics, jcfg,
                             chunk_size=4, seed=0)
    keys = [jax.random.split(jax.random.PRNGKey(b), 5) for b in range(2)]
    draws = [_jax_draws(k, jcfg) for k in keys]
    ours = tvo.run_vo_batched(windows, scene.intrinsics, cfg, chunk_size=4, device="cpu", pose_dtype=torch.float64,
                              uniforms=PairDraws(torch.stack([d.essential for d in draws])))
    for b in range(2):
        _assert_runs_agree(ours[b], ref[b], windows[b], scene.intrinsics, jcfg, keys[b], draws[b])


def test_config_json_switches_every_option_in_the_vo_cli(tmp_path, monkeypatch, capsys):
    """A SlamConfig JSON written by the JAX package switches each option on
    in the port's VO CLI as in the JAX one (refine_matches is not a
    SlamConfig field in either)."""
    from slamtpu.utils.config import SlamConfig, save_config
    from slamtpu_torch.cli.visual_odometry import main
    from slamtpu_torch.utils.config import load_config

    from test_torch_cli import CLIP

    jslam = SlamConfig(orb=jdet.OrbConfig(max_features=128, n_levels=4, descriptor_bins=0),
                       ransac=JRansacConfig(iters=32, min_solver="5pt", refit_method="irls", prescore_subset=64,
                                            homography_fallback=True, homography_ratio=0.5, homography_iters=16))
    save_config(jslam, str(tmp_path / "slam.json"))
    ours = load_config(str(tmp_path / "slam.json")).vo()
    assert ours == convert.config_from_jax(jslam.vo())
    assert (ours.orb.descriptor_bins, ours.ransac.refit_method, ours.ransac.prescore_subset,
            ours.ransac.homography_fallback, ours.ransac.homography_ratio) == (0, "irls", 64, True, 0.5)
    monkeypatch.chdir(tmp_path)
    main([CLIP, "--chunk", "8", "--device", "cpu", "--output", str(tmp_path / "t.json"),
          "--config", str(tmp_path / "slam.json")])
    assert "Successful poses:" in capsys.readouterr().out and (tmp_path / "t.json").exists()
