"""The port's mapping layer against the JAX package: the 4x4 closed-form
eigenvector path, DLT triangulation, keyframe re-matching and every map op,
on the same seeded numpy inputs.

Tolerances (measured on this CPU against the jitted JAX functions; each
bar at most 10x the measurement). Masks, slots, ids, counts and Hamming
matches are exact. Eigenvectors of the 4x4 path: f64 4e-14 absolute
(measured 4.2e-15), f32 3e-5 (measured 3.4e-6). The 4x4 inverse: 5e-12
relative (measured 7.1e-13). Triangulated positions, relative to the
point's norm: f64 5e-13 (measured 8.4e-14), f32 5e-4 (measured 5.4e-5);
the eager Triangulator (f64) 1e-13 (measured 1.6e-14). The inputs keep
>= 2 degrees of parallax: for near-parallel rays the f32 DLT is
rounding-chaotic (the shifted 4x4 has a condition near 1e6), so there
neither package agrees with its own f64 result, and masks can flip. Map
projection distances (f32): 2e-4 px (measured 3.1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.feature.matcher import FeatureMatcher as JMatcher
from slamtpu.mapping import map as jmap
from slamtpu.mapping import triangulation as jtri
from slamtpu.odometry.camera import CameraIntrinsics as JCam
from slamtpu.ops import epipolar as jepi
from slamtpu_torch import convert
from slamtpu_torch.feature.matcher import FeatureMatcher as TMatcher
from slamtpu_torch.mapping import map as tmap
from slamtpu_torch.mapping import triangulation as ttri
from slamtpu_torch.odometry.camera import CameraIntrinsics as TCam
from slamtpu_torch.ops import epipolar as tepi
from slamtpu_torch.ops.lie import so3_exp

torch.set_num_threads(1)

# The JAX references run jitted: one compile per variant instead of one per
# primitive (the cold cost of this file).
j_eigvec = jax.jit(jepi.smallest_eigvec, static_argnames=("iters", "method", "block"))
j_inv4 = jax.jit(jepi._inv4x4_spd)
j_triangulate = jax.jit(jtri.triangulate_points, static_argnames=("min_parallax_deg", "max_reproj_error",
                                                                  "enforce_parallax", "enforce_reproj"))
j_insert = jax.jit(jmap.map_insert)
j_update = jax.jit(jmap.map_update_observations)
j_prune = jax.jit(jmap.map_prune, static_argnums=1)
j_find = jax.jit(jmap.map_find_matches, static_argnames=("ratio",))

FX, FY, CX, CY = 300.0, 300.0, 160.0, 120.0
JC, TC = JCam(FX, FY, CX, CY), TCam(FX, FY, CX, CY)


def _spd4(rng, n):
    """SPD 4x4 batch with a clear smallest eigenvalue (gap >= 10x)."""
    q = np.linalg.qr(rng.normal(size=(n, 4, 4)))[0]
    lam = np.concatenate([rng.uniform(1e-6, 1e-3, (n, 1)), rng.uniform(0.05, 5.0, (n, 3))], axis=1)
    return np.einsum("nij,nj,nkj->nik", q, lam, q)


def _align(a, b):
    """Sign-insensitive max difference of unit vectors [..., D]."""
    s = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    return np.abs(a - s * b).max()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 4e-14), (np.float32, 3e-5)])
@pytest.mark.parametrize("block", [1, 3])
def test_smallest_eigvec_4x4_matches_jax(rng, dtype, tol, block):
    ata = _spd4(rng, 64).astype(dtype)
    ours = tepi.smallest_eigvec(torch.from_numpy(ata), iters=3, block=block).numpy()
    ref = np.asarray(j_eigvec(jnp.asarray(ata), iters=3, block=block))
    assert ours.dtype == dtype
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)
    exact = np.linalg.eigh(ata.astype(np.float64))[1][..., 0]
    assert _align(ours.astype(np.float64), exact) < 1e-3  # three rounds converge as far as the 10x gap allows


def test_inv4x4_matches_jax(rng):
    m = _spd4(rng, 32)
    np.testing.assert_allclose(tepi._inv4x4_spd(torch.from_numpy(m)).numpy(),
                               np.asarray(j_inv4(jnp.asarray(m))), rtol=5e-12)


def _two_views(rng, n=200):
    """Points in front of two cameras 1 m apart (>= 2 degrees of parallax),
    some of them behind camera 1, with pixel noise."""
    x = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 20, n)], 1)
    x[: n // 10, 2] *= -1.0  # behind both cameras
    r1, t1 = np.eye(3), np.zeros(3)
    r2 = so3_exp(torch.tensor([0.02, -0.05, 0.01], dtype=torch.float64)).numpy()
    t2 = np.array([-1.0, 0.05, 0.1])

    def proj(r, t):
        pc = x @ r.T + t
        return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1)

    p1 = proj(r1, t1) + rng.normal(0, 0.5, (n, 2))
    p2 = proj(r2, t2) + rng.normal(0, 0.5, (n, 2))
    p2[-n // 10 :] += rng.normal(0, 40, (n // 10, 2))  # gross outliers for the reprojection filter
    return (r1, t1), (r2, t2), p1, p2


@pytest.mark.parametrize("dtype,tol", [(np.float64, 5e-13), (np.float32, 5e-4)])
@pytest.mark.parametrize("filters", [dict(), dict(enforce_parallax=True, min_parallax_deg=4.0),
                                     dict(enforce_reproj=True, max_reproj_error=2.0)])
def test_triangulate_points_matches_jax(rng, dtype, tol, filters):
    pose1, pose2, p1, p2 = _two_views(rng)
    p1, p2 = p1.astype(dtype), p2.astype(dtype)
    xyz, valid = ttri.triangulate_points(TC, tuple(map(torch.from_numpy, pose1)), tuple(map(torch.from_numpy, pose2)),
                                         torch.from_numpy(p1), torch.from_numpy(p2), **filters)
    jxyz, jvalid = j_triangulate(JC, pose1, pose2, jnp.asarray(p1), jnp.asarray(p2), **filters)
    jvalid = np.asarray(jvalid)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    assert 0 < jvalid.sum() < len(jvalid)  # each filter accepts some points and rejects others
    assert xyz.dtype == torch.float32 if dtype == np.float32 else xyz.dtype == torch.float64
    jxyz = np.asarray(jxyz)
    rel = np.abs(xyz.numpy() - jxyz)[jvalid].max(axis=1) / np.linalg.norm(jxyz[jvalid], axis=1)
    assert rel.max() < tol


def test_triangulator_matches_jax(rng, monkeypatch):
    monkeypatch.setattr(jtri, "triangulate_points", j_triangulate)  # the JAX wrapper, jitted inside
    pose1, pose2, p1, p2 = _two_views(rng, 60)
    desc = rng.integers(0, 256, (60, 32), dtype=np.uint8)
    ours = ttri.Triangulator(TC, device="cpu").with_enforcement(parallax=True, reproj=False).triangulate(pose1, pose2, p1, p2, desc)
    ref = jtri.Triangulator(JC).with_enforcement(parallax=True, reproj=False).triangulate(pose1, pose2, p1, p2, desc)
    assert [p.id for p in ours] == [p.id for p in ref] and len(ours) > 20
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.position, np.asarray(b.position), rtol=1e-13)
        np.testing.assert_array_equal(a.descriptor, b.descriptor)
    batch = ttri.Triangulator(TC, device="cpu").triangulate_batch(pose1, pose2, torch.from_numpy(p1), torch.from_numpy(p2),
                                                    mask=np.arange(60) < 30)
    assert int(batch.count()) == sum(p.id < 30 for p in ours)
    assert ttri.Triangulator(TC, device="cpu").triangulate(pose1, pose2, np.zeros((0, 2)), np.zeros((0, 2))) == []
    with pytest.raises(ValueError):
        ttri.Triangulator(TC, device="cpu").triangulate(pose1, pose2, np.zeros((3, 2)), np.zeros((4, 2)))


def test_match_descriptors_exact(rng):
    q = rng.integers(0, 256, (70, 32), dtype=np.uint8)
    t = np.concatenate([q[:40] ^ rng.integers(0, 2, (40, 32), dtype=np.uint8), rng.integers(0, 256, (30, 32), dtype=np.uint8)])
    t[40] = t[3]  # a tie: the first minimum wins
    qm, tm = rng.uniform(size=70) < 0.9, rng.uniform(size=70) < 0.9
    for masks in ((None, None), (qm, tm)):
        ours = TMatcher().match_descriptors(torch.from_numpy(q), torch.from_numpy(t),
                                            *[None if m is None else torch.from_numpy(m) for m in masks])
        ref = JMatcher().match_descriptors(q, t, *masks)
        good = TMatcher().filter_good_matches(ours, 2.0)
        jgood = JMatcher().filter_good_matches(ref, 2.0)
        for a, b in zip((*ours, good.mask), (*ref, jgood.mask)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for n, m in ((0, 5), (5, 0)):
        ours = TMatcher().match_descriptors(torch.zeros((n, 32), dtype=torch.uint8), torch.zeros((m, 32), dtype=torch.uint8))
        ref = JMatcher().match_descriptors(np.zeros((n, 32), np.uint8), np.zeros((m, 32), np.uint8))
        assert ours.mask.shape == (n,) and not ours.mask.any() and np.asarray(ref.mask).shape == (n,)


def _state_pair(rng, capacity=64):
    """The same seeded map in both packages: 40 inserted points (some behind
    the camera or out of bounds), then a few observation increments."""
    pos = np.stack([rng.uniform(-4, 4, 40), rng.uniform(-3, 3, 40), rng.uniform(2, 15, 40)], 1).astype(np.float32)
    pos[:4, 2] = -3.0
    pos[4:6, 0] = 80.0  # projects past u = 4000
    desc = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    mask = rng.uniform(size=40) < 0.9
    js = j_insert(jmap.MapState.empty(capacity), pos, desc, mask)
    ts = tmap.map_insert(tmap.MapState.empty(capacity), torch.from_numpy(pos), torch.from_numpy(desc),
                         torch.from_numpy(mask))
    return js, ts, pos, desc


def _assert_state_equal(ts, js):
    for name in tmap.MapState._fields:
        ours, ref = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert ours.dtype == ref.dtype, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)


def test_map_insert_prune_and_overflow_exact(rng):
    js, ts, pos, desc = _state_pair(rng)
    _assert_state_equal(ts, js)
    hit = rng.uniform(size=64) < 0.5
    js = j_update(js, hit)
    ts = tmap.map_update_observations(ts, torch.from_numpy(hit))
    _assert_state_equal(ts, js)
    js, ts = j_prune(js, 2), tmap.map_prune(ts, 2)
    _assert_state_equal(ts, js)
    # Refill the freed slots, then overflow the capacity: the rows past the
    # free-slot count are dropped, next_id still counts every masked row.
    for n in (20, 50):
        p = rng.normal(size=(n, 3)).astype(np.float32)
        d = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        m = rng.uniform(size=n) < 0.8
        js = j_insert(js, p, d, m)
        ts = tmap.map_insert(ts, torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(m))
        _assert_state_equal(ts, js)
    assert int(ts.size()) == ts.capacity


def test_map_find_matches_exact(rng):
    js, ts, pos, desc = _state_pair(rng, capacity=48)
    r = so3_exp(torch.tensor([0.01, 0.03, -0.02])).numpy()
    t = np.array([0.1, -0.2, 0.3], np.float32)
    pc = pos @ r.T + t
    kp = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1).astype(np.float32)
    kp += rng.normal(0, 2.0, kp.shape).astype(np.float32)
    frame_desc = desc ^ (rng.uniform(size=desc.shape) < 0.04).astype(np.uint8)
    frame_desc[35] = frame_desc[12]  # a tie between two keypoints
    fmask = rng.uniform(size=40) < 0.9
    idx, good, dist = tmap.map_find_matches(ts, TC, torch.from_numpy(frame_desc), torch.from_numpy(fmask),
                                            torch.from_numpy(r), torch.from_numpy(t), frame_xy=torch.from_numpy(kp))
    jidx, jgood, jdist = j_find(js, JC, frame_desc, fmask, r, t, frame_xy=kp)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(good.numpy(), np.asarray(jgood))
    assert 10 < int(good.sum()) < int(ts.size())
    jdist = np.asarray(jdist)
    np.testing.assert_array_equal(np.isinf(dist.numpy()), np.isinf(jdist))
    fin = np.isfinite(jdist)
    np.testing.assert_allclose(dist.numpy()[fin], jdist[fin], rtol=0, atol=2e-4)
    # Pre-unpacked map bits give the same answer, and the no-xy form drops dist.
    from slamtpu_torch.ops.hamming import descriptor_bits

    bits, pops = descriptor_bits(ts.descriptors)
    idx2, good2 = tmap.map_find_matches(ts, TC, torch.from_numpy(frame_desc), torch.from_numpy(fmask),
                                        torch.from_numpy(r), torch.from_numpy(t), map_bits=bits, map_pops=pops)
    assert torch.equal(idx2, idx) and torch.equal(good2, good)


def test_map_wrapper_matches_jax(rng, monkeypatch):
    for name, fn in (("map_insert", j_insert), ("map_update_observations", j_update), ("map_prune", j_prune),
                     ("map_find_matches", j_find)):
        monkeypatch.setattr(jmap, name, fn)  # the JAX wrapper, jitted inside
    pts = [ttri.MapPoint(position=np.array([x, 0.1 * x, 5.0 + x]), descriptor=rng.integers(0, 256, 32, dtype=np.uint8))
           for x in np.linspace(-1, 1, 12)]
    pts[3].descriptor = None
    jpts = [jtri.MapPoint(position=p.position, descriptor=p.descriptor) for p in pts]
    ours, ref = tmap.Map(TC, capacity=32, device="cpu"), jmap.Map(JC, capacity=32)
    ours.add_points(pts)
    ref.add_points(jpts)
    desc = np.stack([p.descriptor if p.descriptor is not None else np.zeros(32, np.uint8) for p in pts])
    pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    m_ours, m_ref = ours.find_matches(desc[::2], pose), ref.find_matches(desc[::2], pose)
    assert m_ours == m_ref and len(m_ours) >= 6
    ours.update_observations(m_ours)
    ref.update_observations(m_ref)
    assert [(p.id, p.observations) for p in ours.stable_points()] == [(p.id, p.observations) for p in ref.stable_points()]
    assert ours.prune_outliers() == ref.prune_outliers() and ours.size() == ref.size()
    ours.clear()
    assert ours.size() == 0 and ours.points() == []


def test_map_state_from_numpy_roundtrip(rng):
    js, ts, _, _ = _state_pair(rng)
    _assert_state_equal(convert.map_state_from_numpy(js), js)
