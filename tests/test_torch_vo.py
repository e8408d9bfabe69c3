"""The VO slice end to end: the port's vo_chunk against the JAX package's
with the same RANSAC draws, chunked vs whole-clip runs, a carry handed over
from JAX, the renderer copy, and the package rules (no jax, CUDA default).

Tolerances. Match counts, inlier counts, success and keyframe flags are
exact. Poses are not bit-comparable: both sides run the pipeline in f32
and round differently (XLA contracts multiply-adds into FMAs; the QR
factors differ in the last bits), and the five-point root finding
amplifies that into a different RANSAC winner with the same inlier count
on some pairs, after which the 3-round GN polish lands near, not on, the
JAX pose. (Even at fp64 a near-degenerate minimal sample, whose
elimination matrix reaches 1e8, can flip a tie between hypotheses on a
clip's real matches; tests/test_torch_two_view.py holds the solver to
1e-5 at fp64 on well-conditioned scenes.) Measured on this clip, also with
PyTorch's and XLA's CPU kernels forced to AVX2: rotations within 1.7e-4
(0.01 degree), composed translations within 9.1e-3. The bars keep 10x and
5x of headroom: 0.1 degree geodesic, 0.05.

Which winner RANSAC elects stops mattering once the polish converges: with
30 GN rounds both sides reach the same optimum of the inliers' weighted
Sampson error, and the whole slice (detector, matching, RANSAC, polish,
cheirality, keyframes, composition) then agrees at 1e-4 on rotations,
translations and global poses (measured: 5.8e-7, 2.0e-5 and 2.8e-5).
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.feature.detector import OrbConfig as JOrbConfig
from slamtpu.io.synthetic import render_sequence as j_render
from slamtpu.mapping.keyframe import KeyframeState as JKeyframeState
from slamtpu.odometry.trajectory import Trajectory as JTrajectory
from slamtpu.ops.ransac import RansacConfig as JRansacConfig
from slamtpu.pipeline import vo as jvo
from slamtpu_torch import convert
from slamtpu_torch.io.synthetic import render_sequence as t_render
from slamtpu_torch.mapping.keyframe import KeyframeState
from slamtpu_torch.odometry.camera import CameraIntrinsics
from slamtpu_torch.ops.ransac import pair_uniforms
from slamtpu_torch.pipeline import vo as tvo

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CHUNK = 3
SCENE = dict(n_frames=6, height=160, width=200, n_points=600, step=0.3, seed=3, textured=True)


@pytest.fixture(scope="module")
def setup():
    scene = t_render(**SCENE)
    jcfg = jvo.VoConfig(orb=JOrbConfig(max_features=96, n_levels=4), ransac=JRansacConfig(iters=16, min_solver="5pt"))
    tcfg = convert.config_from_jax(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(0), SCENE["n_frames"] - 1)
    step_keys = jnp.concatenate([keys[:1], keys])  # masked-seed schedule: step 0's key is unused
    draws = np.array(jax.vmap(lambda k: jax.random.uniform(k, (16, 96), dtype=jnp.float32))(step_keys))
    step = jax.jit(jvo.vo_chunk, static_argnames=("config",))
    cam_j = j_render(**SCENE).intrinsics
    carry = (jvo.seed_features(jcfg.orb), JKeyframeState.initial(), jnp.eye(4))
    jax_carries, jax_results = [carry], []
    for start in range(0, SCENE["n_frames"], CHUNK):
        mask = np.arange(start, start + CHUNK) >= 1
        carry, res = step(*carry, scene.frames[start : start + CHUNK], step_keys[start : start + CHUNK],
                          cam_j, jcfg, mask)
        jax_carries.append(carry)
        jax_results.append(jax.tree_util.tree_map(np.asarray, res))
    return scene, tcfg, draws, jax_carries, jax_results


def _port_chunk(carry, scene, tcfg, draws, start):
    mask = torch.arange(start, start + CHUNK) >= 1
    frames = torch.from_numpy(scene.frames[start : start + CHUNK])
    return tvo.vo_chunk(*carry, frames, scene.intrinsics, tcfg, mask,
                        uniforms=torch.from_numpy(draws[start : start + CHUNK]))


def _angle_deg(a, b):
    """Geodesic angle between rotations [..., 3, 3]."""
    tr = np.einsum("...ij,...ij->...", np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def _assert_chunk_matches(ours, ref):
    np.testing.assert_array_equal(ours.num_matches.numpy(), ref.num_matches)
    np.testing.assert_array_equal(ours.num_inliers.numpy(), ref.num_inliers)
    np.testing.assert_array_equal(ours.success.numpy(), ref.success)
    np.testing.assert_array_equal(ours.is_keyframe.numpy(), ref.is_keyframe)
    assert _angle_deg(ours.rotations.numpy(), ref.rotations).max() < 0.1
    assert _angle_deg(ours.global_poses.numpy()[:, :3, :3], ref.global_poses[:, :3, :3]).max() < 0.1
    np.testing.assert_allclose(ours.global_poses.numpy()[:, :3, 3], ref.global_poses[:, :3, 3], rtol=0, atol=0.05)


def test_vo_chunks_match_jax(setup):
    scene, tcfg, draws, _, jax_results = setup
    carry = (tvo.seed_features(tcfg.orb), KeyframeState.initial(), torch.eye(4, dtype=torch.float64))
    for i, start in enumerate(range(0, SCENE["n_frames"], CHUNK)):
        carry, res = _port_chunk(carry, scene, tcfg, draws, start)
        _assert_chunk_matches(res, jax_results[i])
    successes = np.concatenate([r.success for r in jax_results])
    assert successes[1:].all() and not successes[0]  # every real pair succeeds; the seed step is masked
    assert min(r.num_matches[1:].min() if i == 0 else r.num_matches.min() for i, r in enumerate(jax_results)) >= 20


def test_vo_chunk_matches_jax_at_1e4_once_polish_converges(setup):
    scene, _, draws, _, _ = setup
    jcfg = jvo.VoConfig(orb=JOrbConfig(max_features=96, n_levels=4),
                        ransac=JRansacConfig(iters=16, min_solver="5pt", refine_rounds=30))
    keys = jax.random.split(jax.random.PRNGKey(0), SCENE["n_frames"] - 1)
    step_keys = jnp.concatenate([keys[:1], keys])
    mask = np.arange(SCENE["n_frames"]) >= 1
    _, ref = jax.jit(jvo.vo_chunk, static_argnames=("config",))(
        jvo.seed_features(jcfg.orb), JKeyframeState.initial(), jnp.eye(4), scene.frames, step_keys,
        j_render(**SCENE).intrinsics, jcfg, mask)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    tcfg = convert.config_from_jax(jcfg)
    carry = (tvo.seed_features(tcfg.orb), KeyframeState.initial(), torch.eye(4, dtype=torch.float64))
    _, ours = tvo.vo_chunk(*carry, torch.from_numpy(scene.frames), scene.intrinsics, tcfg,
                           torch.from_numpy(mask), uniforms=torch.from_numpy(draws))
    for name in ("num_matches", "num_inliers", "success", "is_keyframe"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), getattr(ref, name), err_msg=name)
    assert ref.success[1:].all()
    for name in ("rotations", "translations", "global_poses"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), getattr(ref, name), rtol=0, atol=1e-4,
                                   err_msg=name)


def test_carry_from_jax_gives_same_second_chunk(setup):
    scene, tcfg, draws, jax_carries, jax_results = setup
    feats, state, pose = jax.tree_util.tree_map(np.asarray, jax_carries[1])
    carry = convert.carry_from_numpy(feats, state, pose)
    _, res = _port_chunk(carry, scene, tcfg, draws, CHUNK)
    _assert_chunk_matches(res, jax_results[1])


def test_run_vo_chunked_equals_whole_clip(setup):
    scene, tcfg, _, _, _ = setup
    whole = tvo.run_vo(scene.frames, scene.intrinsics, tcfg, seed=4, device="cpu")
    chunked = tvo.run_vo(scene.frames, scene.intrinsics, tcfg, chunk_size=4, seed=4, device="cpu")
    for name in ("num_matches", "num_inliers", "success", "is_keyframe", "rotations", "translations"):
        np.testing.assert_array_equal(getattr(chunked, name), getattr(whole, name), err_msg=name)
    assert whole.successful_frames == SCENE["n_frames"] - 1
    assert whole.trajectory.to_json() == chunked.trajectory.to_json()
    # The trajectory is the JAX package's Trajectory fed the same keyframes.
    ref = JTrajectory()
    for idx in np.nonzero(whole.is_keyframe)[0]:
        ref.update(whole.rotations[idx], whole.translations[idx], idx + 2, (idx + 1) / tcfg.fps)
    assert whole.trajectory.to_json() == ref.to_json()


def test_pair_uniforms_cpu_values_unchanged():
    """The draws are made on a CPU generator for every device; on the CPU
    they are the numbers the per-device generators gave before, so a seed
    keeps its CPU results."""
    u = pair_uniforms(0, [0, 5, 300], 4, 6, "cpu")
    assert u.dtype == torch.float32 and u.shape == (3, 4, 6) and u.device.type == "cpu"
    assert u[:, 0, :3].tolist() == [[0.11343264579772949, 0.9062243700027466, 0.39901453256607056],
                                    [0.20227974653244019, 0.9049655795097351, 0.7126179933547974],
                                    [0.14581942558288574, 0.013644874095916748, 0.014033913612365723]]
    assert u[:, 3, 5].tolist() == [0.8387730121612549, 0.007410585880279541, 0.949773907661438]
    u = pair_uniforms(7, [2], 64, 500, "cpu")
    assert float(u.double().sum()) == 15954.60813510418 and u[0, 63, 499].item() == 0.031466662883758545
    torch.testing.assert_close(pair_uniforms(7, [9, 2], 64, 500, "cpu")[1], u[0], rtol=0, atol=0)


def test_run_vo_takes_uniforms_and_pose_dtype(setup):
    """run_vo(seed=s) is run_vo(uniforms=<the seed's draws per pair>); the
    pose-chain dtype does not change the host results."""
    scene, tcfg, _, _, _ = setup
    n_pairs = SCENE["n_frames"] - 1
    seeded = tvo.run_vo(scene.frames, scene.intrinsics, tcfg, chunk_size=4, seed=4, device="cpu")
    draws = pair_uniforms(4, range(n_pairs), tcfg.ransac.iters, tcfg.orb.max_features, "cpu")
    for pose_dtype in (torch.float32, torch.float64):
        given = tvo.run_vo(scene.frames, scene.intrinsics, tcfg, chunk_size=4, uniforms=draws, device="cpu",
                           pose_dtype=pose_dtype)
        for name in ("num_matches", "num_inliers", "success", "is_keyframe", "rotations", "translations"):
            np.testing.assert_array_equal(getattr(given, name), getattr(seeded, name), err_msg=name)
        assert given.trajectory.to_json() == seeded.trajectory.to_json()


def test_run_vo_matches_jax_run_vo_on_its_draws(setup):
    """The port's run_vo, handed the JAX package's per-pair draws
    (jax.random.uniform of split(PRNGKey(0), T-1)), against the JAX
    run_vo at seed 0, both with an f64 pose chain (JAX runs under x64
    here): counts and flags exact, rotations within the module's 0.1
    degree bar."""
    scene, tcfg, draws, _, _ = setup
    jscene = j_render(**SCENE)
    jcfg = jvo.VoConfig(orb=JOrbConfig(max_features=96, n_levels=4), ransac=JRansacConfig(iters=16, min_solver="5pt"))
    ref = jvo.run_vo(jscene.frames, jscene.intrinsics, jcfg, chunk_size=CHUNK, seed=0)
    ours = tvo.run_vo(scene.frames, scene.intrinsics, tcfg, chunk_size=CHUNK, uniforms=draws[1:], device="cpu",
                      pose_dtype=torch.float64)
    for name in ("num_matches", "num_inliers", "success", "is_keyframe"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), err_msg=name)
    assert _angle_deg(ours.rotations, ref.rotations).max() < 0.1
    assert len(ours.trajectory) == len(ref.trajectory)


def test_renderer_copy_matches_jax():
    kw = dict(n_frames=3, height=64, width=96, n_points=200, step=0.3, seed=1, textured=True)
    ours, ref = t_render(**kw), j_render(**kw)
    np.testing.assert_array_equal(ours.frames, ref.frames)
    np.testing.assert_array_equal(ours.rel_rotations, ref.rel_rotations)
    np.testing.assert_array_equal(ours.rel_translations, ref.rel_translations)
    assert ours.intrinsics.fx == ref.intrinsics.fx and ours.intrinsics.cy == ref.intrinsics.cy


def test_config_from_jax_maps_every_field():
    assert convert.config_from_jax(jvo.VoConfig()) == tvo.VoConfig()
    assert convert.config_from_jax(jvo.VoConfig.robust()).ransac.iters == 256


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tvo.run_vo(np.zeros((2, 96, 96), np.uint8), CameraIntrinsics.kitti(), tvo.VoConfig(refine_matches=True),
                   device="cpu")


def test_run_vo_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = t_render(n_frames=2, height=64, width=64, n_points=50, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tvo.run_vo(scene.frames, scene.intrinsics)


_SLICE_MODULES = [
    "slamtpu_torch", "slamtpu_torch._build", "slamtpu_torch.convert",
    "slamtpu_torch.feature.detector", "slamtpu_torch.feature.matcher", "slamtpu_torch.io.synthetic",
    "slamtpu_torch.mapping.keyframe", "slamtpu_torch.odometry.camera", "slamtpu_torch.odometry.pose",
    "slamtpu_torch.odometry.trajectory", "slamtpu_torch.ops.brief", "slamtpu_torch.ops.corner",
    "slamtpu_torch.ops.epipolar", "slamtpu_torch.ops.fast", "slamtpu_torch.ops.five_point",
    "slamtpu_torch.ops.hamming", "slamtpu_torch.ops.harris", "slamtpu_torch.ops.lie",
    "slamtpu_torch.ops.patch", "slamtpu_torch.ops.pyramid", "slamtpu_torch.ops.ransac",
    "slamtpu_torch.pipeline.vo", "slamtpu_torch.io.export", "slamtpu_torch.mapping.triangulation",
    "slamtpu_torch.mapping.map", "slamtpu_torch.mapping.bundle_adjustment", "slamtpu_torch.pipeline.point_cloud",
    "slamtpu_torch.io.checkpoint", "slamtpu_torch.models.resnet", "slamtpu_torch.models.depth_decoder",
    "slamtpu_torch.depth.monodepth2", "slamtpu_torch.depth.convert", "slamtpu_torch.pipeline.depth_mapping",
    "slamtpu_torch.io.video", "slamtpu_torch.cli.depth_estimation",
    "slamtpu_torch.utils.evaluate", "slamtpu_torch.utils.config", "slamtpu_torch.utils.metrics",
    "slamtpu_torch.utils.viz", "slamtpu_torch.io.kitti", "slamtpu_torch.io.native_loader", "slamtpu_torch.io.real",
    "slamtpu_torch.cli.visual_odometry", "slamtpu_torch.cli.point_cloud", "slamtpu_torch.cli.main",
    "slamtpu_torch.cli.visualize_features", "slamtpu_torch.cli.bundle_adjustment",
]


def test_package_imports_neither_jax_nor_slamtpu():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in _SLICE_MODULES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'slamtpu'))\n"
        + "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_sources_never_name_jax_or_slamtpu():
    files = sorted((REPO / "slamtpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    found = set(p.stem for p in (REPO / "slamtpu_torch").rglob("*.py"))
    assert {m.rsplit(".", 1)[-1] for m in _SLICE_MODULES[1:]} <= found
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "slamtpu"), f"{path}: imports {name}"
