"""The port on the card: the hand-written CUDA kernels against their plain
PyTorch versions (also at the VO cells' full chunk shapes), one launch of
each kernel a chunk on every main path, and the pipelines against the CPU,
ground truth and their own bars. Marked `cuda`: each test skips on a host
without a CUDA device (the decision is made inside the fixture, never at
import). No JAX here, so on the GPU
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py` runs them."""

import dataclasses
import gc
import os

import numpy as np
import pytest
import torch

from slamtpu_torch.ops import five_point
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
from test_torch_nullspace import DEGENERATE, assert_null_basis, degenerate_sample, gap_bound

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


def _clip():
    """The 257-frame 1241x376 clip of the VO cells' size (KITTI intrinsics,
    4000 landmarks, step 0.8, seed 0, noise 2.0), rendered once into
    .scene_cache."""
    from slamtpu_torch.io.synthetic import render_sequence_cached
    from slamtpu_torch.odometry.camera import CameraIntrinsics

    return render_sequence_cached(n_frames=257, height=376, width=1241, n_points=4000, step=0.8,
                                  intrinsics=CameraIntrinsics.kitti(), seed=0, noise=2.0)


def _vo_chunk(cuda):
    """The clip's first 32-frame chunk as the detector sees it: the 8-level
    pyramid, the levels that take the Harris map, the starts of the windows
    it selects on each level (from the plain corner maps) and the blurred
    levels."""
    from slamtpu_torch.feature.detector import OrbConfig, _select_level, features_per_level
    from slamtpu_torch.ops.pyramid import build_pyramid, gaussian_blur

    cfg = OrbConfig()
    chunk = torch.as_tensor(_clip().frames[:32]).to(cuda).float()
    levels = [x.contiguous() for x in build_pyramid(chunk, cfg.n_levels, cfg.scale_factor)]
    flags = [lv <= cfg.subpixel_max_octave for lv in range(cfg.n_levels)]
    ranked, harris = corner_response_levels_plain(levels, cfg.fast_threshold, flags)
    quotas = features_per_level(cfg.max_features, cfg.n_levels, cfg.scale_factor)
    starts = [(torch.round(_select_level(r, q, cfg.edge_threshold, h)[0]).to(torch.int32) - PATCH_RADIUS).contiguous()
              for r, q, h in zip(ranked, quotas, harris)]
    return levels, flags, starts, [gaussian_blur(x) for x in levels]


@pytest.mark.parametrize("case", ["odd_levels", "vo_chunk"])
def test_corner_levels_kernel_matches_plain(cuda, case):
    """One launch over levels of odd widths, a tiny last level and a flat
    one, or over a VO chunk's 8-level pyramid of 32 x 1241 x 376: corner
    sets identical everywhere, Harris bit-identical at least 4 px from the
    border (the kernel clamps its halo where the plain version wraps)."""
    if case == "odd_levels":
        levels = [_images(3, 2, 97, 203), _images(4, 2, 40, 59), _images(5, 2, 33, 131),
                  torch.zeros((2, 64, 70)), _images(6, 2, 5, 9)]
        levels = [x.to(cuda).contiguous() for x in levels]
        flags = [True, False, True, False, True]
    else:
        levels, flags = _vo_chunk(cuda)[:2]
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
    if case == "odd_levels":
        assert not torch.isfinite(ranked[3]).any() and not torch.isfinite(ranked[4]).any()


@pytest.mark.parametrize("case", ["edge_starts", "vo_chunk", "vo_chunk_raw_and_blurred"])
def test_patch_levels_kernel_matches_plain(cuda, case):
    """One launch over levels with K_l not a multiple of 4, a level without
    an image (zero windows), and starts on and beyond every border; or over
    the windows the detector selects on a VO chunk's 8 blurred levels of
    32 x 1241 x 376, alone or with the raw levels' windows in the same
    16-level launch (descriptor_bins=0). Bit-exact."""
    if case == "edge_starts":
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
    else:
        raw, _, starts, levels = _vo_chunk(cuda)
        if case == "vo_chunk_raw_and_blurred":
            levels, starts = raw + levels, starts + starts
    before = extract_patches_batched.launches
    out = extract_patches_levels(levels, starts, PATCH_RADIUS)
    assert extract_patches_batched.launches == before + 1
    assert torch.equal(out, extract_patches_levels_plain(levels, starts, PATCH_RADIUS))
    if case == "edge_starts":
        assert out.shape == (3, 27, 39, 39)
        assert torch.equal(out[:, 13:16], torch.zeros_like(out[:, 13:16]))
        small = extract_patches_levels(levels[2:], starts[2:], 3)
        assert torch.equal(small, extract_patches_levels_plain(levels[2:], starts[2:], 3))
    else:  # the per-level entry point launches the same kernel on one level
        for img, st in zip(levels, starts):
            assert torch.equal(extract_patches_batched(img, st, PATCH_RADIUS), extract_patches_plain(img, st, PATCH_RADIUS))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        corner_response(torch.zeros((1, 64, 64), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        extract_patches_batched(torch.zeros((1, 20, 20), device=cuda),
                                torch.zeros((1, 1, 2), dtype=torch.int32, device=cuda), PATCH_RADIUS)


def _systems(shape, seed, dtype=torch.float32):
    """Independent uniform [*shape, 5, 2] samples in both views."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(-0.8, 0.8, (*shape, 5, 2))).to(dtype) for _ in range(2))


def _nearby_views(shape, seed):
    """[*shape, 5, 2] samples of two views ~5 px apart at KITTI's field of
    view: small parallax, the ill-conditioned A of a forward-moving camera."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-0.85, 0.9, (*shape, 5)), rng.uniform(-0.27, 0.27, (*shape, 5))], -1)
    return tuple(torch.from_numpy(v.astype(np.float32)) for v in (x, x + rng.normal(0.0, 0.007, x.shape)))


@pytest.mark.parametrize("shape,views", [((32, 64), "uniform"), ((4, 32, 64), "uniform"), ((4, 32, 64), "nearby"),
                                         ((32, 64), "nearby")])
def test_nullspace_kernel_is_the_library_qr_to_the_bit(cuda, shape, views):
    """At the VO chunks' shapes: Q's last four columns exactly as the
    library's complete QR of A^T gives them on the card, also where A is
    ill-conditioned and any other rounding would move them by eps cond(A)."""
    p1, p2 = (x.to(cuda) for x in (_systems(shape, 0) if views == "uniform" else _nearby_views(shape, 0)))
    got = five_point._nullspace4(p1, p2)
    assert got.shape == (*shape, 4, 3, 3) and got.dtype == torch.float32
    assert torch.equal(got, five_point._nullspace4_plain(p1, p2))


def test_nullspace_kernel_matches_library_qr_at_f64(cuda):
    """float64 (the kernel's f32 order of operations, not the library's f64
    one): element by element within 1e-12, or 4 eps kappa(A) for a system
    whose conditioning alone parts two QRs by more (`gap_bound`)."""
    p1, p2 = (x.to(cuda) for x in _systems((32, 64), 0, torch.float64))
    got = five_point._nullspace4(p1, p2)
    assert got.dtype == torch.float64
    gap = (got - five_point._nullspace4_plain(p1, p2)).abs().amax((-1, -2, -3)).cpu()
    assert bool((gap <= gap_bound(p1, p2, 1e-12)).all())


@pytest.mark.parametrize("name", ("random",) + DEGENERATE)
def test_nullspace_kernel_is_an_orthonormal_null_basis(cuda, name):
    p1, p2 = _systems((32, 64), 3) if name == "random" else degenerate_sample(name)
    p1, p2 = p1.to(cuda), p2.to(cuda)
    assert_null_basis(five_point._nullspace4(p1, p2), p1, p2)


def test_nullspace_kernel_is_batch_invariant(cuda):
    """A system's basis is the same bits alone as inside 8,192 systems."""
    p1, p2 = (x.to(cuda) for x in _systems((8192,), 1))
    batch = five_point._nullspace4(p1, p2)
    for i in (0, 1, 127, 128, 4095, 8191):
        alone = five_point._nullspace4(p1[i : i + 1].contiguous(), p2[i : i + 1].contiguous())
        assert torch.equal(alone[0], batch[i])


def test_nullspace_kernel_makes_no_host_sync_and_counts_its_launches(cuda):
    p1, p2 = (x.to(cuda) for x in _systems((4, 32, 64), 2))
    five_point._nullspace4(p1, p2)  # build and load outside the check
    torch.cuda.synchronize()
    before = five_point._nullspace4.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            five_point._nullspace4(p1, p2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert five_point._nullspace4.launches == before + 3


def test_nullspace_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    p1, p2 = (x.to(cuda) for x in _systems((2, 3), 2))
    for a, b in ((p1.half(), p2.half()), (p1[..., :4, :].contiguous(), p2[..., :4, :].contiguous()),
                 (p1.transpose(0, 1), p2.transpose(0, 1)), (p1, p2.cpu()), (p1.cpu(), p2)):
        with pytest.raises(ValueError):
            five_point._nullspace4(a, b)


def test_nullspace_kernel_counter_counts_the_chunks_of_run_vo(cuda):
    """Traced run_vo on the card: the main path's null space went through
    the kernel once a chunk, as `_nullspace4.launches` counts."""
    from slamtpu_torch.pipeline.vo import run_vo
    from slamtpu_torch.utils import metrics

    scene, cfg = _options_scene()
    before = five_point._nullspace4.launches
    with metrics.tracing():
        run_vo(scene.frames, scene.intrinsics, cfg, chunk_size=4, seed=2, device=cuda)
    chunks = sum(s.name == "vo.chunk" for s in metrics.records().spans)
    assert chunks == -(-len(scene.frames) // 4) == five_point._nullspace4.launches - before


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
    draws; two card runs identical. Returns (scene, the card's result)."""
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
    return scene, gpu


def test_run_point_cloud_cuda_matches_cpu(cuda):
    """Same keyframes, successes, BA runs; the census within the
    fused-vs-host bars; each kernel launched once per chunk plus frame 0;
    run_global_ba on the card's result lowers a finite error."""
    from slamtpu_torch.pipeline.point_cloud import run_global_ba, run_point_cloud

    scene, gpu = _flagship_cuda_matches_cpu(run_point_cloud, cuda)
    _, before, after = run_global_ba(gpu, scene.intrinsics, device=cuda)
    assert np.isfinite(after) and after <= before


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


def _options_scene():
    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.ops.ransac import RansacConfig
    from slamtpu_torch.pipeline.vo import VoConfig

    scene = render_sequence(n_frames=13, height=160, width=240, n_points=600, step=0.3, seed=3, textured=True)
    return scene, VoConfig(orb=OrbConfig(max_features=128, n_levels=4), ransac=RansacConfig(iters=32, min_solver="5pt"))


def test_run_vo_batched_cuda_equals_run_vo(cuda):
    """Two windows in one pass on the card: one launch of each kernel a
    chunk for both, and each sequence equal to run_vo of its window at
    seed + b on the card (success, matches, keyframes; rotations 1e-5)."""
    from slamtpu_torch.pipeline.vo import run_vo, run_vo_batched

    scene, cfg = _options_scene()
    windows = np.stack([scene.frames[:9], scene.frames[4:]])
    before = (corner_response.launches, extract_patches_batched.launches)
    runs = run_vo_batched(windows, scene.intrinsics, cfg, chunk_size=4, seed=2, device=cuda)
    assert (corner_response.launches - before[0], extract_patches_batched.launches - before[1]) == (3, 3)
    for b, run in enumerate(runs):
        solo = run_vo(windows[b], scene.intrinsics, cfg, chunk_size=4, seed=2 + b, device=cuda)
        for name in ("success", "num_matches", "is_keyframe"):
            np.testing.assert_array_equal(getattr(run, name), getattr(solo, name), err_msg=name)
        np.testing.assert_allclose(run.rotations, solo.rotations, rtol=0, atol=1e-5)
        assert run.successful_frames >= 6


def test_continuous_brief_cuda_matches_cpu(cuda):
    """descriptor_bins=0 on the card: the raw and blurred windows in one K2
    launch; keypoints as on the CPU and descriptor bytes equal but for
    rounding ties (99 %, as test_run_vo_cuda_matches_cpu holds binned BRIEF)."""
    import dataclasses

    from slamtpu_torch.feature.detector import detect_and_compute

    scene, cfg = _options_scene()
    orb = dataclasses.replace(cfg.orb, descriptor_bins=0)
    frames = torch.from_numpy(scene.frames[:4])
    before = extract_patches_batched.launches
    gpu = detect_and_compute(frames.to(cuda), orb)
    assert extract_patches_batched.launches == before + 1
    cpu = detect_and_compute(frames, orb)
    assert torch.equal(gpu.mask.cpu(), cpu.mask)
    assert float((gpu.xy.cpu() - cpu.xy).abs().max()) < 1e-3
    assert float((gpu.descriptors.cpu() == cpu.descriptors).float().mean()) > 0.99


def test_pose_options_cuda_match_cpu_at_f64(cuda):
    """The five-point RANSAC, the homography fallback with the IRLS refit,
    prescore, and refine_matches on the card against the CPU on the same
    inputs and draws: f64 poses within 1e-6, inlier sets equal; refined
    points exact."""
    from slamtpu_torch.odometry.pose import estimate_relative_pose
    from slamtpu_torch.ops.patch_refine import refine_matches
    from slamtpu_torch.ops.ransac import PairDraws, RansacConfig

    scene, _ = _options_scene()
    cam = scene.intrinsics
    pix = []
    for f in (0, 1):
        pc = scene.points @ scene.rotations[f].T + scene.translations[f]
        pix.append(np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx, cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1))
    noise = np.random.default_rng(0).normal(0.0, 0.5, (2,) + pix[0].shape)
    p1, p2 = (torch.from_numpy(pix[f][:300] + noise[f][:300]) for f in (0, 1))
    gen = torch.Generator().manual_seed(0)
    draws = PairDraws(torch.rand((64, 300), generator=gen), torch.rand((64, 300), generator=gen),
                      torch.rand((300,), generator=gen))
    for cfg in (RansacConfig(iters=64, min_solver="5pt"),
                RansacConfig(iters=64, homography_fallback=True, homography_iters=64, refit_method="irls"),
                RansacConfig(iters=64, min_solver="5pt", prescore_subset=100)):
        ref = estimate_relative_pose(cam, p1, p2, config=cfg, uniforms=draws)
        gpu = estimate_relative_pose(cam, p1.to(cuda), p2.to(cuda), config=cfg,
                                     uniforms=PairDraws(*[d.to(cuda) for d in draws]))
        assert torch.equal(gpu.inliers.cpu(), ref.inliers) and bool(gpu.valid) == bool(ref.valid)
        torch.testing.assert_close(gpu.rotation.cpu(), ref.rotation, rtol=0, atol=1e-6)
    frames = torch.from_numpy(scene.frames[:2])
    q1 = torch.from_numpy(np.random.default_rng(1).uniform(5, 230, (200, 2)).astype(np.float32))
    q2 = q1 + 1.3
    mask = torch.ones(200, dtype=torch.bool)
    ref = refine_matches(frames[0], frames[1], q1, q2, mask)
    gpu = refine_matches(frames[0].to(cuda), frames[1].to(cuda), q1.to(cuda), q2.to(cuda), mask.to(cuda))
    torch.testing.assert_close(gpu.cpu(), ref, rtol=0, atol=1e-5)


def test_run_vo_cuda_matches_cpu(cuda):
    """The detector at binned BRIEF on the card as on the CPU (masks equal,
    keypoints within 1e-3 px, descriptor bytes equal but for rounding ties);
    run_vo on both at one seed: the same matches and successes, each within
    1 degree of the true rotations. In f32 the two devices may elect
    another five-point winner (ROADMAP A1), so their poses are held to
    ground truth, not to each other."""
    from slamtpu_torch.feature.detector import detect_and_compute
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.pipeline.vo import run_vo

    _, cfg = _options_scene()
    scene = render_sequence(n_frames=8, height=160, width=240, n_points=600, step=0.3, seed=3, textured=True)
    frames = torch.from_numpy(scene.frames)
    gpu, cpu = detect_and_compute(frames.to(cuda), cfg.orb), detect_and_compute(frames, cfg.orb)
    assert torch.equal(gpu.mask.cpu(), cpu.mask)
    assert float((gpu.xy.cpu() - cpu.xy).abs().max()) < 1e-3
    assert float((gpu.descriptors.cpu() == cpu.descriptors).float().mean()) > 0.99
    runs = [run_vo(scene.frames, scene.intrinsics, cfg, chunk_size=4, device=dev) for dev in (cuda, "cpu")]
    np.testing.assert_array_equal(runs[0].num_matches, runs[1].num_matches)
    np.testing.assert_array_equal(runs[0].success, runs[1].success)
    for run in runs:
        tr = np.einsum("tij,tij->t", run.rotations, scene.rel_rotations)
        err = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
        assert run.success.any() and np.median(err[run.success]) <= 1.0


VO_OPTIONS = {
    "refine_matches": lambda c: dataclasses.replace(c, refine_matches=True),
    "homography_fallback": lambda c: dataclasses.replace(c, ransac=dataclasses.replace(c.ransac,
                                                                                       homography_fallback=True)),
    "irls": lambda c: dataclasses.replace(c, ransac=dataclasses.replace(c.ransac, refit_method="irls")),
    "prescore_subset": lambda c: dataclasses.replace(c, ransac=dataclasses.replace(c.ransac, prescore_subset=128)),
    "descriptor_bins=0": lambda c: dataclasses.replace(c, orb=dataclasses.replace(c.orb, descriptor_bins=0)),
    "robust": lambda c: type(c).robust(),
}


def _launches():
    return corner_response.launches, extract_patches_batched.launches, five_point._nullspace4.launches


def _assert_vo_gates(run, rel_rotations):
    """The VO cells' ground-truth bars: finite rotations, success on at
    least 80 % of the pairs, median rotation error at most 1 degree."""
    ok = np.asarray(run.success, bool)
    assert np.isfinite(run.rotations).all()
    tr = np.einsum("tij,tij->t", run.rotations, rel_rotations[:len(ok)])
    err = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    assert ok.mean() >= 0.8 and np.median(err[ok]) <= 1.0


@pytest.mark.parametrize("path", ["run_vo", "run_vo_batched", "run_point_cloud", "run_point_cloud_fused",
                                  "run_depth_mapping", *VO_OPTIONS])
def test_each_main_path_launches_each_kernel_once_a_chunk(cuda, path):
    """K1, K2 and N1 (counted as (K1, K2, N1)) once a chunk. On the
    257-frame 1241x376 clip in chunks of 32, 9 of each with the VO gates:
    run_vo at VoConfig() and with each VO option, and run_depth_mapping,
    whose VO runs in chunks of 32. On small clips: run_vo_batched, once for
    all its sequences, and both flagship runners, with one more detection
    for frame 0 (at full size in the next test)."""
    from slamtpu_torch.pipeline import point_cloud
    from slamtpu_torch.pipeline.depth_mapping import run_depth_mapping
    from slamtpu_torch.pipeline.vo import VoConfig, run_vo, run_vo_batched

    if path == "run_vo_batched":
        scene, cfg = _options_scene()  # 9 frames each: 3 chunks of 4
        before = _launches()
        run_vo_batched(np.stack([scene.frames[:9], scene.frames[4:]]), scene.intrinsics, cfg, chunk_size=4,
                       device=cuda)
        want = (3, 3, 3)
    elif path.startswith("run_point_cloud"):
        scene, cfg = _small_flagship()  # 16 pairs: 2 chunks of 8
        before = _launches()
        getattr(point_cloud, path)(scene.frames, scene.intrinsics, cfg, chunk_size=8, device=cuda)
        want = (3, 3, 2)
    elif path == "run_depth_mapping":
        scene = _clip()
        before = _launches()
        res = run_depth_mapping(scene.frames, scene.intrinsics, lambda f: np.full(np.shape(f), 5.0, np.float32),
                                stride=8, device=cuda)
        want = (9, 9, 9)
        assert len(res.points) and np.isfinite(res.points).all()
        _assert_vo_gates(res.vo_run, scene.rel_rotations)
    else:
        scene = _clip()
        before = _launches()
        run = run_vo(scene.frames, scene.intrinsics, VO_OPTIONS.get(path, lambda c: c)(VoConfig()), chunk_size=32,
                     device=cuda)
        want = (9, 9, 9)
        _assert_vo_gates(run, scene.rel_rotations)
    assert tuple(a - b for a, b in zip(_launches(), before)) == want


def _schedule(res):
    """What two runs at one seed must share: keyframes, BA runs, and the
    map's ids and validity."""
    return res.keyframe_frame_idx, res.ba_runs, res.map_state.ids.cpu().numpy(), res.map_state.valid.cpu().numpy()


def test_fused_runner_matches_the_host_loop_at_full_size_and_frees_its_memory(cuda):
    """PointCloudConfig() on the 257-frame 1241x376 clip in chunks of 32:
    each runner launches K1 and K2 9 times (8 chunks and frame 0) and N1 8
    times; the fused runner keeps the host loop's keyframes with its census
    within the JAX package's fused-vs-host bars (tests/test_point_cloud.py;
    BA runs may differ, ROADMAP A4), both pass the flagship's gates, a
    second fused run repeats the first's schedule, and once its result is
    deleted the card holds at most 64 MiB more than before it."""
    from slamtpu_torch.pipeline.point_cloud import PointCloudConfig, run_point_cloud, run_point_cloud_fused

    scene, cfg = _clip(), PointCloudConfig()
    runs = []
    for runner in (run_point_cloud, run_point_cloud_fused):
        before = _launches()
        runs.append(runner(scene.frames, scene.intrinsics, cfg, chunk_size=32, device=cuda))
        assert tuple(a - b for a, b in zip(_launches(), before)) == (9, 9, 8), runner.__name__
    host, fused = runs
    np.testing.assert_array_equal(fused.keyframe_frame_idx, host.keyframe_frame_idx)
    n_f, n_h = int(fused.map_state.valid.sum()), int(host.map_state.valid.sum())
    o_f, o_h = len(fused.observations[0]), len(host.observations[0])
    assert abs(n_f - n_h) <= max(3, 0.02 * n_h) and abs(o_f - o_h) <= 0.05 * o_h
    for res in runs:
        rot = res.keyframe_rotations.astype(np.float64)
        assert res.successful_frames >= 0.8 * (len(scene.frames) - 1) and res.ba_runs > 0
        assert np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max() <= 1e-4
    first = _schedule(fused)
    del runs, host, fused, res
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = run_point_cloud_fused(scene.frames, scene.intrinsics, cfg, chunk_size=32, device=cuda)
    for a, b in zip(first, _schedule(out)):
        np.testing.assert_array_equal(a, b)
    del out
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - before <= 64 * 2**20


def test_run_depth_mapping_cuda_on_true_depth(cuda):
    """tests/test_depth_mapping.py's end-to-end check with VO on the card:
    the renderer's depth maps in place of the network, the cloud's median
    relative error under 0.15."""
    from slamtpu_torch.feature.detector import OrbConfig
    from slamtpu_torch.io.synthetic import render_sequence
    from slamtpu_torch.ops.ransac import RansacConfig
    from slamtpu_torch.pipeline.depth_mapping import run_depth_mapping
    from slamtpu_torch.pipeline.vo import VoConfig

    scene = render_sequence(n_frames=12, height=192, width=256, n_points=500, step=1.0, seed=6, render_depth=True)
    depth = {f.tobytes(): d for f, d in zip(scene.frames, scene.depths)}
    cfg = VoConfig(orb=OrbConfig(max_features=250), ransac=RansacConfig(iters=200))
    res = run_depth_mapping(scene.frames, scene.intrinsics, lambda f: depth[np.asarray(f).tobytes()], vo_config=cfg,
                            stride=6, keyframe_stride=2, device=cuda)
    assert len(res.points) > 300 and np.isfinite(res.points).all()
    d = np.linalg.norm(res.points[:, None, :] - scene.points[None, :, :], axis=-1)
    assert np.median(d.min(axis=1) / np.maximum(np.linalg.norm(res.points, axis=1), 1.0)) < 0.15


def test_eager_wrappers_on_the_card(cuda):
    """One pair through the root package's OrbDetector, PoseEstimator and
    KeyframeSelector: a finite pose on at least 8 inliers."""
    import slamtpu_torch
    from slamtpu_torch.feature.matcher import FeatureMatcher

    scene, cfg = _options_scene()
    det = slamtpu_torch.OrbDetector(max_features=cfg.orb.max_features, device=cuda)
    f1, f2 = det.detect_and_compute(scene.frames[0]), det.detect(scene.frames[1])
    matcher = FeatureMatcher()
    good = matcher.filter_good_matches(matcher.match_descriptors(f1.descriptors, f2.descriptors, f1.mask, f2.mask))
    est = slamtpu_torch.PoseEstimator(scene.intrinsics, device=cuda)
    p1, p2 = est.extract_matched_points(f1.xy.cpu().numpy(), f2.xy.cpu().numpy(), good)
    res = est.compute_essential_matrix(p1, p2, config=cfg.ransac)
    rot, trans = est.recover_pose(res, p1, p2)
    slamtpu_torch.KeyframeSelector(device=cuda).should_be_keyframe(rot, trans, len(p1))
    assert np.isfinite(rot).all() and np.isfinite(trans).all() and int(res.num_inliers) >= 8


def test_step_timer_and_profile_trace_on_the_card(cuda, tmp_path):
    """StepTimer around a run that force_sync waits for, and a Chrome trace
    of a run from profile_trace."""
    from slamtpu_torch.pipeline.vo import run_vo
    from slamtpu_torch.utils.metrics import StepTimer, force_sync, profile_trace

    scene, cfg = _options_scene()
    timer = StepTimer()
    timer.start()
    force_sync(run_vo(scene.frames, scene.intrinsics, cfg, chunk_size=4, device=cuda))
    timer.stop()
    assert timer.times[0] > 0
    with profile_trace(str(tmp_path / "trace")) as trace_dir:
        run_vo(scene.frames, scene.intrinsics, cfg, chunk_size=4, device=cuda)
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0
