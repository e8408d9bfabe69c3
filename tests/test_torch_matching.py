"""The port's Hamming matching against the JAX package: bit packing,
distances, best matches and the good-match filter — all exact, ties
included (jnp.argmin / jnp.argmax pick the first index, and so must the
port)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamtpu.feature.matcher import FeatureMatcher as JMatcher
from slamtpu.ops import hamming as jham
from slamtpu.ops import ransac as jransac
from slamtpu_torch.feature.matcher import FeatureMatcher as TMatcher
from slamtpu_torch.ops import hamming as tham
from slamtpu_torch.ops import ransac as transac
from slamtpu_torch.ops.epipolar import eight_point, enforce_rank2, sampson_error

torch.set_num_threads(1)


def _descriptors(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def test_bit_packing_matches_jax(rng):
    packed = _descriptors(rng, 40)
    bits = tham.unpack_bits(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(bits, np.asarray(jham.unpack_bits(jnp.asarray(packed))))
    np.testing.assert_array_equal(tham.pack_bits(torch.from_numpy(bits)).numpy(), packed)
    tb, tp = tham.descriptor_bits(torch.from_numpy(packed))
    jb, jp = jham.descriptor_bits(jnp.asarray(packed))
    np.testing.assert_array_equal(tb.float().numpy(), np.asarray(jb, np.float32))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _match_both(q, t, qm, tm, ratio=2.0):
    jm = JMatcher()
    jq, jqp = jham.descriptor_bits(jnp.asarray(q))
    jt, jtp = jham.descriptor_bits(jnp.asarray(t))
    ref = jm.match_from_bits(jq, jqp, jnp.asarray(qm), jt, jtp, jnp.asarray(tm))
    ref_good = jm.filter_good_matches(ref, ratio)
    tmch = TMatcher()
    tq, tqp = tham.descriptor_bits(torch.from_numpy(q))
    tt, ttp = tham.descriptor_bits(torch.from_numpy(t))
    ours = tmch.match_from_bits(tq, tqp, torch.from_numpy(qm), tt, ttp, torch.from_numpy(tm))
    ours_good = tmch.filter_good_matches(ours, ratio)
    return ref, ref_good, ours, ours_good


def _assert_same(ref, ref_good, ours, ours_good):
    np.testing.assert_array_equal(ours.train_idx.numpy(), np.asarray(ref.train_idx))
    np.testing.assert_array_equal(ours.distance.numpy(), np.asarray(ref.distance))
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(ours_good.mask.numpy(), np.asarray(ref_good.mask))


def test_hamming_distances_match_jax_and_popcount(rng):
    q, t = _descriptors(rng, 50), _descriptors(rng, 70)
    tq, tqp = tham.descriptor_bits(torch.from_numpy(q))
    tt, ttp = tham.descriptor_bits(torch.from_numpy(t))
    ours = tham.hamming_matrix_from_bits(tq, tqp, tt, ttp).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jham.hamming_matrix(jnp.asarray(q), jnp.asarray(t))))
    popcount = np.unpackbits(q[:, None, :] ^ t[None, :, :], axis=-1).sum(-1)
    np.testing.assert_array_equal(ours, popcount)


def test_matches_match_jax(rng):
    q, t = _descriptors(rng, 64), _descriptors(rng, 64)
    # Near-copies so that the good-match filter keeps some and drops some.
    t[:20] = q[rng.permutation(64)[:20]] ^ (rng.uniform(size=(20, 32)) < 0.02).astype(np.uint8)
    qm = rng.uniform(size=64) < 0.9
    tm = rng.uniform(size=64) < 0.9
    ref, ref_good, ours, ours_good = _match_both(q, t, qm, tm)
    _assert_same(ref, ref_good, ours, ours_good)
    assert 0 < int(ours_good.mask.sum()) < int(ours.mask.sum())


def test_ties_break_to_first_index_like_jax(rng):
    """Built on purpose with tied distances (duplicated and masked train
    rows) and tied inlier counts (a noise-free scene where many RANSAC
    hypotheses reach the same count)."""
    q = _descriptors(rng, 32)
    t = np.concatenate([q[:8], q[:8], _descriptors(rng, 16)])  # rows k and k+8 tie exactly
    tm = np.ones(32, bool)
    tm[3] = False  # the first of a tied pair masked: the second must win
    ref, ref_good, ours, ours_good = _match_both(q, t, np.ones(32, bool), tm)
    _assert_same(ref, ref_good, ours, ours_good)
    assert ours.train_idx[0] == 0 and ours.train_idx[3] == 11
    all_dead = _match_both(q, t, np.ones(32, bool), np.zeros(32, bool))
    _assert_same(*all_dead)

    # Tied inlier counts: a generous threshold makes every hypothesis from
    # a noisy but outlier-free scene count all N points; the hypotheses
    # themselves differ, so agreeing on E proves both took the first.
    n, iters = 40, 16
    x = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n), rng.uniform(4, 9, n)], 1)
    p1 = x[:, :2] / x[:, 2:] + rng.normal(0, 1e-3, (n, 2))
    x2 = x + np.array([0.4, 0.0, 0.1])
    p2 = x2[:, :2] / x2[:, 2:] + rng.normal(0, 1e-3, (n, 2))
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, (iters, n), dtype=jnp.float32))
    cfg = dict(iters=iters, min_solver="8pt", refit_method="none")
    ref = jransac.ransac_essential(key, jnp.asarray(p1), jnp.asarray(p2), threshold_norm=0.05,
                                   config=jransac.RansacConfig(**cfg))
    ours = transac.ransac_essential(torch.from_numpy(p1), torch.from_numpy(p2), threshold_norm=0.05,
                                    config=transac.RansacConfig(**cfg), uniforms=torch.from_numpy(u))
    assert int(ours.best_iter_inliers) == int(ref.best_iter_inliers) == n
    e_ref = np.asarray(ref.essential)
    e_ours = ours.essential.numpy()
    sign = np.sign(np.sum(e_ref * e_ours))
    np.testing.assert_allclose(sign * e_ours, e_ref, atol=1e-9)

    idx = torch.sort(torch.from_numpy(u), dim=-1, descending=True, stable=True)[1][:, :8]
    hyps = eight_point(torch.from_numpy(p1)[idx], torch.from_numpy(p2)[idx])
    counts = (sampson_error(hyps, torch.from_numpy(p1)[None], torch.from_numpy(p2)[None]) < 0.05**2).sum(-1)
    tied = torch.nonzero(counts == counts.max())[:, 0]
    assert len(tied) >= 2
    first, last = enforce_rank2(hyps[tied[0]]), enforce_rank2(hyps[tied[-1]])
    assert min(float((first - last).abs().max()), float((first + last).abs().max())) > 1e-6
