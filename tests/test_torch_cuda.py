"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked `cuda`: each test skips on a host without a CUDA device
(the decision is made inside the fixture, never at import). On the GPU:
`python -m pytest -m cuda tests/test_torch_cuda.py`. chip_smoke.py holds
the same kernels at the VO chunk's full shapes."""

import numpy as np
import pytest
import torch

from slamtpu_torch.ops.brief import PATCH_RADIUS
from slamtpu_torch.ops.corner import (
    corner_response,
    corner_response_levels,
    corner_response_levels_plain,
    corner_response_plain,
)
from slamtpu_torch.ops.patch import (
    extract_patches_batched,
    extract_patches_levels,
    extract_patches_levels_plain,
    extract_patches_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _images(seed, b=3, h=97, w=203):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (b, h, w)).astype(np.float32)
    # Smooth then add blobs so there are corners of every strength.
    img = torch.nn.functional.avg_pool2d(torch.from_numpy(img)[:, None], 5, 1, 2)[:, 0]
    return img + torch.from_numpy(rng.uniform(0, 60, (b, h, w)).astype(np.float32))


def test_corner_kernel_matches_plain(cuda):
    imgs = _images(0).to(cuda)
    before = corner_response.launches
    rk, hk = corner_response(imgs, 20.0, with_harris=True)
    rp, hp = corner_response_plain(imgs, 20.0, with_harris=True)
    assert corner_response.launches == before + 1
    m = 10
    np.testing.assert_array_equal(torch.isfinite(rk[:, m:-m, m:-m]).cpu().numpy(),
                                  torch.isfinite(rp[:, m:-m, m:-m]).cpu().numpy())
    assert int(torch.isfinite(rk).sum()) > 100
    torch.testing.assert_close(hk[:, m:-m, m:-m], hp[:, m:-m, m:-m], rtol=1e-4, atol=0)
    torch.testing.assert_close(corner_response(imgs, 20.0), rk, rtol=0, atol=0)
    assert not torch.isfinite(corner_response(torch.zeros((1, 64, 128), device=cuda))).any()


def test_patch_kernel_matches_plain(cuda):
    imgs = _images(1, b=2, h=90, w=260).to(cuda)
    rng = np.random.default_rng(2)
    starts = np.stack([rng.integers(-30, 260, (2, 33)), rng.integers(-30, 90, (2, 33))], -1).astype(np.int32)
    starts = torch.from_numpy(starts).to(cuda)
    before = extract_patches_batched.launches
    out = extract_patches_batched(imgs, starts, PATCH_RADIUS)
    assert extract_patches_batched.launches == before + 1
    torch.testing.assert_close(out, extract_patches_plain(imgs, starts, PATCH_RADIUS), rtol=0, atol=0)


def test_corner_levels_kernel_matches_plain(cuda):
    """One launch over levels of odd widths, a tiny last level and a flat
    one: corner sets identical everywhere, Harris bit-identical at least
    4 px from the border (the kernel clamps its halo where the plain
    version wraps)."""
    levels = [_images(3, 2, 97, 203), _images(4, 2, 40, 59), _images(5, 2, 33, 131),
              torch.zeros((2, 64, 70)), _images(6, 2, 5, 9)]
    levels = [x.to(cuda).contiguous() for x in levels]
    flags = [True, False, True, False, True]
    before = corner_response.launches
    ranked, harris = corner_response_levels(levels, 20.0, flags)
    assert corner_response.launches == before + 1
    ref_ranked, ref_harris = corner_response_levels_plain(levels, 20.0, flags)
    m = 4
    for lv, (rk, rp, hk, hp) in enumerate(zip(ranked, ref_ranked, harris, ref_harris)):
        assert torch.equal(torch.isfinite(rk), torch.isfinite(rp)), lv
        assert (hk is None) == (hp is None)
        if rk.shape[1] > 2 * m and rk.shape[2] > 2 * m:
            assert torch.equal(rk[:, m:-m, m:-m], rp[:, m:-m, m:-m]), lv
            if hk is not None:
                assert torch.equal(hk[:, m:-m, m:-m], hp[:, m:-m, m:-m]), lv
        # The per-level entry point launches the same kernel on one level.
        single = corner_response(levels[lv], 20.0, with_harris=flags[lv])
        assert torch.equal(single[0] if flags[lv] else single, rk), lv
    assert int(torch.isfinite(ranked[0]).sum()) > 100
    assert not torch.isfinite(ranked[3]).any() and not torch.isfinite(ranked[4]).any()


def test_patch_levels_kernel_matches_plain(cuda):
    """One launch over levels with K_l not a multiple of 4, a level without
    an image (zero windows), and starts on and beyond every border."""
    levels = [_images(7, 3, 90, 261), None, _images(8, 3, 45, 77), _images(9, 3, 39, 39)]
    levels = [None if x is None else x.to(cuda).contiguous() for x in levels]
    rng = np.random.default_rng(10)
    starts = []
    for img, k in zip(levels, (13, 3, 6, 5)):
        h, w = (50, 50) if img is None else img.shape[1:]
        s = np.stack([rng.integers(-40, w + 5, (3, k)), rng.integers(-40, h + 5, (3, k))], -1)
        s[:, 0], s[:, 1], s[:, 2] = (0, 0), (w - 39, h - 39), (-7, h)
        s[:, -1] = (w, -3)
        starts.append(torch.from_numpy(s.astype(np.int32)).to(cuda))
    before = extract_patches_batched.launches
    out = extract_patches_levels(levels, starts, PATCH_RADIUS)
    assert extract_patches_batched.launches == before + 1
    assert out.shape == (3, 27, 39, 39)
    assert torch.equal(out, extract_patches_levels_plain(levels, starts, PATCH_RADIUS))
    assert torch.equal(out[:, 13:16], torch.zeros_like(out[:, 13:16]))
    small = extract_patches_levels(levels[2:], starts[2:], 3)
    assert torch.equal(small, extract_patches_levels_plain(levels[2:], starts[2:], 3))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        corner_response(torch.zeros((1, 64, 64), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        extract_patches_batched(torch.zeros((1, 20, 20), device=cuda),
                                torch.zeros((1, 1, 2), dtype=torch.int32, device=cuda), PATCH_RADIUS)


def _ba_problem(seed, n_poses, n_points, dtype):
    """A seeded BA problem: landmarks seen by a band of poses, noisy start."""
    from slamtpu_torch.mapping.bundle_adjustment import ObservationBatch
    from slamtpu_torch.ops.lie import so3_exp

    rng = np.random.default_rng(seed)
    gt = np.stack([rng.uniform(-2, 2 + 0.4 * n_poses, n_points), rng.uniform(-1.5, 1.5, n_points),
                   rng.uniform(6, 12, n_points)], 1)
    rots = so3_exp(torch.from_numpy(rng.normal(scale=0.02, size=(n_poses, 3)))).numpy()
    trans = np.stack([[-0.4 * i, 0.0, 0.0] for i in range(n_poses)]) + rng.normal(scale=0.02, size=(n_poses, 3))
    first = rng.integers(0, n_poses, n_points)
    kf = np.concatenate([np.minimum(first + d, n_poses - 1) for d in range(3)])
    pt = np.tile(np.arange(n_points), 3)
    keep = np.unique(kf * n_points + pt, return_index=True)[1]
    kf, pt = kf[keep], pt[keep]
    pc = np.einsum("mij,mj->mi", rots[kf], gt[pt]) + trans[kf]
    px = np.stack([500.0 * pc[:, 0] / pc[:, 2] + 320.0, 500.0 * pc[:, 1] / pc[:, 2] + 240.0], 1)
    px += rng.normal(scale=0.5, size=px.shape)
    noisy = so3_exp(torch.from_numpy(rng.normal(scale=0.003, size=(n_poses, 3)))).numpy() @ rots
    args = [noisy, trans + rng.normal(scale=0.01, size=trans.shape), gt + rng.normal(scale=0.05, size=gt.shape)]
    obs = ObservationBatch(torch.from_numpy(kf), torch.from_numpy(pt), torch.from_numpy(px).to(dtype),
                           torch.ones(len(kf), dtype=torch.bool))
    return [torch.from_numpy(a).to(dtype) for a in args], obs


def test_ba_solve_cuda_matches_cpu(cuda):
    """ba_solve at f64: CUDA (auto = gather, observer bound counted) against
    the CPU's scatter path, a window-sized and a chunked global problem; a
    repeated CUDA solve is bit-identical."""
    from slamtpu_torch.mapping.bundle_adjustment import ObservationBatch, ba_solve
    from slamtpu_torch.odometry.camera import CameraIntrinsics

    cam = CameraIntrinsics(500.0, 500.0, 320.0, 240.0)
    for n_poses, n_points, chunk in ((5, 300, 2048), (24, 500, 128)):
        (rot, trans, pts), obs = _ba_problem(n_poses, n_poses, n_points, torch.float64)
        mask = torch.ones(n_poses, dtype=torch.bool)
        mask[:2] = False
        kw = dict(fix_first_pose=False, pose_mask=mask, landmark_chunk=chunk)
        ref = ba_solve(cam, rot, trans, pts, obs, **kw)
        gpu_obs = ObservationBatch(*[x.to(cuda) for x in obs])
        out = ba_solve(cam, rot.to(cuda), trans.to(cuda), pts.to(cuda), gpu_obs, **kw)
        again = ba_solve(cam, rot.to(cuda), trans.to(cuda), pts.to(cuda), gpu_obs, **kw)
        assert out[4] == ref[4] >= 2
        for a, b, c in zip(out[:4], ref[:4], again[:4]):
            # Summation order differs (gather vs scatter, card vs host) and LM
            # carries it: 1e-8 of the largest coordinate.
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-8 * max(float(b.abs().max()), 1.0))
            assert torch.equal(a, c)


def _small_flagship():
    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.ops.ransac import RansacConfig
    from slamtpu_torch.pipeline.point_cloud import PointCloudConfig
    from slamtpu_torch.pipeline.vo import VoConfig

    scene = render_sequence(n_frames=17, height=160, width=200, n_points=600, step=0.3, seed=8, textured=True)
    cfg = PointCloudConfig(vo=VoConfig(orb=OrbConfig(max_features=96, n_levels=4),
                                       ransac=RansacConfig(iters=16, min_solver="5pt", refine_rounds=30),
                                       keyframe=PointCloudConfig().vo.keyframe), map_capacity=2048)
    return scene, cfg


def _flagship_cuda_matches_cpu(runner, cuda):
    """A small flagship run on the card against the CPU with the same
    draws; two card runs identical."""
    scene, cfg = _small_flagship()
    draws = torch.rand((16, 16, 96), generator=torch.Generator().manual_seed(0))
    cpu = runner(scene.frames, scene.intrinsics, cfg, chunk_size=8, device="cpu", uniforms=draws)
    before = (corner_response.launches, extract_patches_batched.launches)
    gpu = runner(scene.frames, scene.intrinsics, cfg, chunk_size=8, device=cuda, uniforms=draws.to(cuda))
    assert (corner_response.launches - before[0], extract_patches_batched.launches - before[1]) == (3, 3)
    np.testing.assert_array_equal(gpu.keyframe_frame_idx, cpu.keyframe_frame_idx)
    assert (gpu.ba_runs, gpu.successful_frames) == (cpu.ba_runs, cpu.successful_frames) and cpu.ba_runs > 0
    n_gpu, n_cpu = int(gpu.map_state.valid.sum()), int(cpu.map_state.valid.sum())
    assert abs(n_gpu - n_cpu) <= max(3, 0.02 * n_cpu)
    assert abs(len(gpu.observations[0]) - len(cpu.observations[0])) <= 0.05 * len(cpu.observations[0])
    again = runner(scene.frames, scene.intrinsics, cfg, chunk_size=8, device=cuda, uniforms=draws.to(cuda))
    assert torch.equal(again.map_state.ids, gpu.map_state.ids) and torch.equal(again.map_state.valid, gpu.map_state.valid)
    np.testing.assert_array_equal(again.keyframe_rotations, gpu.keyframe_rotations)


def test_run_point_cloud_cuda_matches_cpu(cuda):
    """Same keyframes, successes, BA runs; the census within the
    fused-vs-host bars; each kernel launched once per chunk plus frame 0."""
    from slamtpu_torch.pipeline.point_cloud import run_point_cloud

    _flagship_cuda_matches_cpu(run_point_cloud, cuda)


def test_run_point_cloud_fused_cuda_matches_cpu(cuda):
    from slamtpu_torch.pipeline.point_cloud import run_point_cloud_fused

    _flagship_cuda_matches_cpu(run_point_cloud_fused, cuda)


def test_fused_phase2_chunk_makes_no_host_sync(cuda):
    """Without BA, a phase-2 chunk reads nothing back from the card."""
    import dataclasses

    from slamtpu_torch.pipeline import point_cloud as pc
    from slamtpu_torch.pipeline.vo import vo_frontend

    scene, cfg = _small_flagship()
    cfg = dataclasses.replace(cfg, ba_interval=0, prune_interval=3)
    feats0 = pc._first_features(scene.frames, cfg, cuda)
    carry1 = (feats0, pc.KeyframeState.initial(cuda), torch.eye(4, dtype=torch.float64, device=cuda))
    _, res, feats = vo_frontend(*carry1, torch.as_tensor(scene.frames[1:9]).to(cuda), scene.intrinsics, cfg.vo,
                                first_step=1)
    is_kf = res.is_keyframe.cpu().numpy()
    carry2 = pc._fused_carry_init(cfg, feats0, torch.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, outs = pc._fused_phase2_chunk(carry2, feats, res.rotations, res.translations, is_kf, scene.intrinsics, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(is_kf.sum()) >= 4 and outs.obs_mask.shape == (8, cfg.max_obs_per_kf)


def test_monodepth2_cuda_matches_cpu(cuda):
    """MonoDepth2 at 96x160 with the same random weights on the card and the
    host, f32 with TF32 off, an input that needs the antialiased downscale:
    disparity within 5e-4 (the JAX parity bar); bf16 on the card against f32
    at tests/test_depth.py's bars."""
    from slamtpu_torch.depth.monodepth2 import MonoDepth2

    cpu = MonoDepth2(width=160, height=96, seed=1, device="cpu")
    gpu = MonoDepth2(encoder=cpu.encoder.state_dict(), decoder=cpu.decoder.state_dict(), width=160, height=96,
                     device=cuda)
    g16 = MonoDepth2(encoder=cpu.encoder.state_dict(), decoder=cpu.decoder.state_dict(), width=160, height=96,
                     device=cuda, compute_dtype=torch.bfloat16)
    x = np.random.default_rng(0).uniform(0, 255, (2, 150, 310)).astype(np.uint8)
    ref = cpu.predict_raw(x)
    out = gpu.predict_raw(x)
    assert out.device.type == "cuda" and out.shape == (2, 96, 160)
    torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=5e-4)
    d16 = g16.predict_raw(x).cpu().numpy()
    d32 = out.cpu().numpy()
    assert np.abs(d16 - d32).max() < 0.05
    assert np.corrcoef(d32.ravel(), d16.ravel())[0, 1] > 0.97


def test_seed_draws_are_the_same_on_the_card_and_the_cpu(cuda):
    """F1: a seed gives bit-identical RANSAC draws on the card and the CPU
    (made on a CPU generator, copied from pinned memory), so run_vo(seed=0)
    on the card is run_vo on those CPU draws."""
    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.ops.ransac import RansacConfig, pair_uniforms
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo

    ids = [0, 1, 7, 300]
    gpu = pair_uniforms(5, ids, 64, 500, cuda)
    assert gpu.device.type == "cuda" and torch.equal(gpu.cpu(), pair_uniforms(5, ids, 64, 500, "cpu"))
    scene = render_sequence(n_frames=9, height=160, width=240, n_points=600, step=0.3, seed=3, textured=True)
    cfg = VoConfig(orb=OrbConfig(max_features=128, n_levels=4), ransac=RansacConfig(iters=32, min_solver="5pt"))
    seeded = run_vo(scene.frames, scene.intrinsics, cfg, chunk_size=4, seed=0, device=cuda)
    draws = pair_uniforms(0, range(8), 32, 128, "cpu")
    given = run_vo(scene.frames, scene.intrinsics, cfg, chunk_size=4, uniforms=draws.to(cuda), device=cuda)
    for name in ("num_matches", "num_inliers", "success", "is_keyframe", "rotations", "translations"):
        np.testing.assert_array_equal(getattr(given, name), getattr(seeded, name), err_msg=name)
    assert seeded.successful_frames >= 6
