"""The port's multi-process plumbing (slamtpu_torch/parallel/distributed.py),
as tests/test_distributed.py checks the JAX package's: four Gloo ranks on
the CPU joined once through initialize_multihost's explicit arguments and
once through the SLAMTPU_* variables, each checking its local_time_slice of
the sharded VO step against the serial run_vo (tests/distributed_worker.py's
tiny clip: 8 frames of 120x160, 128 features, 64 hypotheses); and one
process with nothing set, which forms a one-rank group and a (1, 1) mesh,
as a one-GPU user does. The three configurations run at once, spawned once
for the module; every wait has a timeout. The `cuda` cases (they skip
without a card) run the layer on the card against the serial runners
there: one NCCL process, and four Gloo ranks sharing the card.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from slamtpu_torch.io.synthetic import render_sequence
from slamtpu_torch.parallel import distributed as pdist
from slamtpu_torch.pipeline.point_cloud import run_point_cloud_fused
from slamtpu_torch.pipeline.vo import run_vo

import torch_parallel_worker as worker
from torch_parallel_worker import collect, spawn

torch.set_num_threads(1)

N_RANKS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("torch_distributed")
    configs = {
        "explicit": spawn("explicit", N_RANKS, workdir),
        "env": spawn("env", N_RANKS, workdir, lambda rank, port: {
            "SLAMTPU_COORDINATOR": f"127.0.0.1:{port}", "SLAMTPU_NUM_PROCESSES": str(N_RANKS),
            "SLAMTPU_PROCESS_ID": str(rank)}),
        "single": spawn("single", 1, workdir),
    }
    try:
        scene = render_sequence(**worker.TINY)
        serial = run_vo(scene.frames, scene.intrinsics, worker.TINY_VO, chunk_size=2, seed=0, device="cpu")
        fused = run_point_cloud_fused(scene.frames, scene.intrinsics, worker.FLAGSHIP, seed=0, device="cpu")
        out = {mode: collect(procs, mode, workdir, timeout=300) for mode, procs in configs.items()}
    finally:
        for procs in configs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    return out, serial, fused


def _assert_slice_matches_serial(rank: dict, serial):
    """tests/distributed_worker.py's check: this rank's block of the
    sharded step equals the serial run over its [t0, t1)."""
    t0, t1 = rank["slice"]
    vo = {k: v[0] for k, v in rank["vo"].items()}
    np.testing.assert_array_equal(vo["success"], np.concatenate([[False], serial.success])[t0:t1])
    np.testing.assert_array_equal(vo["num_matches"], np.concatenate([[0], serial.num_matches])[t0:t1])
    np.testing.assert_array_equal(vo["is_keyframe"], np.concatenate([[False], serial.is_keyframe])[t0:t1])
    ok = vo["success"]
    serial_rot = np.concatenate([np.eye(3)[None], serial.rotations])[t0:t1]
    np.testing.assert_allclose(vo["rotations"][ok], serial_rot[ok], rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["explicit", "env"])
def test_four_ranks_check_their_time_slice(runs, mode):
    out, serial, _ = runs
    ranks = out[mode]
    assert [r["rank_world"] for r in ranks] == [(i, N_RANKS) for i in range(N_RANKS)]
    assert [r["slice"] for r in ranks] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert all(r["mesh"] == (1, 4) and r["backend"] == "gloo" for r in ranks)
    for r in ranks:
        _assert_slice_matches_serial(r, serial)
    assert serial.success.sum() >= 5


def test_one_process_forms_a_one_rank_group(runs):
    """initialize_multihost() with nothing set: a one-rank group on a free
    local port, make_mesh() gives (1, 1); the sharded step is run_vo, the
    sharded flagship the fused runner, and the batched one (B = 1) the
    sharded one."""
    out, serial, fused = runs
    (single,) = out["single"]
    assert single["rank_world"] == (0, 1) and single["default_mesh"] == (1, 1) and single["backend"] == "gloo"
    _assert_slice_matches_serial(single, serial)
    got = single["sharded_flagship"]
    assert got["kf_idx"].tolist() == fused.keyframe_frame_idx.tolist()
    assert got["ba_runs"] == fused.ba_runs and got["successful"] == fused.successful_frames
    np.testing.assert_array_equal(got["valid"], fused.map_state.valid.numpy())
    np.testing.assert_allclose(got["kf_rot"], fused.keyframe_rotations, rtol=0, atol=1e-6)
    (batched,) = single["batched"]
    for k in ("kf_idx", "valid", "kf_rot", "positions"):
        np.testing.assert_array_equal(batched[k], got[k])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_flagship_bars(got: dict, ref):
    """tests/test_sharding.py's flagship bars: keyframes, BA runs and
    successful frames identical, landmarks within max(15, 15 %)."""
    assert got["kf_idx"].tolist() == ref.keyframe_frame_idx.tolist()
    assert (got["ba_runs"], got["successful"]) == (ref.ba_runs, ref.successful_frames)
    n_got, n_ref = int(got["valid"].sum()), int(ref.map_state.valid.sum())
    assert abs(n_got - n_ref) <= max(15, 0.15 * n_ref), (n_got, n_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["single", "shared"], ids=["one_nccl_rank", "four_gloo_ranks"])
def test_parallel_layer_on_the_card(tmp_path, cuda, mode):
    """One NCCL process: its block of the sharded step against run_vo, its
    sharded flagship against the fused runner, its batched one (B = 1)
    equal to the sharded one. Four Gloo ranks sharing the card: each
    rank's block of the sharded step against run_vo, the batched flagship
    on a (2, 2) mesh against the fused runner of each clip. A rank's step
    detects its block in one launch of each kernel; the serial runs detect
    in the same chunks (the card's resize kernels depend on the batch
    size)."""
    world = 1 if mode == "single" else N_RANKS
    procs = spawn(mode, world, tmp_path, device="cuda")
    try:
        scene = render_sequence(**worker.TINY)
        serial = run_vo(scene.frames, scene.intrinsics, worker.TINY_VO, chunk_size=worker.TINY["n_frames"] // world,
                        seed=0, device=cuda)
        clips = [scene] if world == 1 else [render_sequence(**{**worker.TINY, "seed": s}) for s in worker.SHARED_SEEDS]
        fused = [run_point_cloud_fused(c.frames, c.intrinsics, worker.FLAGSHIP, seed=b, device=cuda)
                 for b, c in enumerate(clips)]
        ranks = collect(procs, mode, tmp_path, timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [r["rank_world"] for r in ranks] == [(i, world) for i in range(world)]
    assert {r["backend"] for r in ranks} == {"nccl" if world == 1 else "gloo"}
    for r in ranks:
        _assert_slice_matches_serial(r, serial)
        assert r["vo_launches"] == (1, 1)
    for got, ref in zip(ranks[0]["batched"], fused, strict=True):
        _assert_flagship_bars(got, ref)
    if world == 1:
        got = ranks[0]["sharded_flagship"]
        _assert_flagship_bars(got, fused[0])
        for k in ("kf_idx", "valid", "kf_rot", "positions"):
            np.testing.assert_array_equal(ranks[0]["batched"][0][k], got[k])
    else:
        for r in ranks[1:]:
            for got, mine in zip(r["batched"], ranks[0]["batched"]):
                np.testing.assert_array_equal(got["valid"], mine["valid"])


def test_default_is_nccl_on_the_card(monkeypatch):
    """With nothing set, initialize_multihost() asks for NCCL on CUDA device
    0 in a one-rank group; without a card it raises before any group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda index: calls.append(("set_device", index)))
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    for k in ("SLAMTPU_COORDINATOR", "SLAMTPU_NUM_PROCESSES", "SLAMTPU_PROCESS_ID", "MASTER_ADDR", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    calls = []
    assert pdist.initialize_multihost() == (0, 1)
    (set_device, (backend, kw)) = calls
    assert set_device == ("set_device", 0) and backend == "nccl"
    assert kw["world_size"] == 1 and kw["rank"] == 0 and kw["init_method"].startswith("tcp://127.0.0.1:")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: pytest.fail("a group was formed"))
    with pytest.raises(RuntimeError, match="CUDA"):
        pdist.initialize_multihost()
    with pytest.raises(ValueError, match="NCCL"):
        pdist.initialize_multihost(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="num_processes"):
        pdist.initialize_multihost("127.0.0.1:1", device="cpu")


class _Mesh:
    """The three DeviceMesh members the helpers read, at one coordinate."""

    mesh_dim_names = ("data", "seq")

    def __init__(self, shape, coord):
        self.shape, self._coord = shape, dict(zip(self.mesh_dim_names, coord))

    def get_local_rank(self, name):
        return self._coord[name]


def test_blocks_and_time_slices_without_a_group():
    mesh = _Mesh((2, 4), (1, 2))
    clip = np.arange(2 * 16 * 3).reshape(2, 16, 3)
    block = pdist.from_process_local(mesh, clip)
    np.testing.assert_array_equal(block, clip[1:2, 8:12])
    assert pdist.from_process_local(mesh, block, clip.shape) is block
    assert pdist.local_time_slice(mesh, 16) == (8, 12)
    with pytest.raises(ValueError):
        pdist.from_process_local(mesh, clip[:, :8], clip.shape)
    with pytest.raises(ValueError):
        pdist.from_process_local(mesh, clip[:, :15])
    with pytest.raises(ValueError):
        pdist.local_time_slice(mesh, 10)


def test_pack_round_trip():
    parts = [torch.rand(3, 2), torch.tensor([True, False, True]), torch.arange(5, dtype=torch.int32),
             torch.randint(0, 255, (2, 7), dtype=torch.uint8), torch.rand(2, dtype=torch.float64)]
    got = pdist.unpack(pdist.pack(parts), parts)
    for a, b in zip(got, parts):
        assert a.dtype == b.dtype and torch.equal(a, b)
