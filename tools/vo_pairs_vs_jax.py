#!/usr/bin/env python3
"""The JAX package's VO and the port's, pair by pair, on the same draws.

    python tools/vo_pairs_vs_jax.py --scene forward --frames 160 [--seed 0]

CPU only; imports both packages, as the tests do, and the ATE gate's scenes
and cv2 oracle from tests/test_ate.py. It renders the gate's fair scene
(`lateral` or `forward`), runs the JAX `run_vo` at `seed` (chunk 32, f64
pose chain under x64) and the port's `run_vo` twice: on the JAX package's
draws (`jax.random.uniform(split(PRNGKey(seed), T-1)[i], (iters, K))` for
pair i) and on its own (`pair_uniforms` under `seed`). It prints each run's
ATE over its common steps with the oracle and the ratio to the oracle's.

Then it lists every pair whose inlier count differs between the JAX run
and the port's run on the JAX draws, or whose rotations differ by more
than 0.1 degree or translation directions by more than 1 degree. For each
such pair it re-runs the RANSAC hypothesis stage of both packages on the
port's correspondences for that pair (its detector, matcher and
per-octave sigma), with the pair's JAX draws, and shows for each
package's winning 5-point root: its Sampson inliers before the rank-2
projection, after its own package's `enforce_rank2`, and after the other
package's `enforce_rank2` of the same matrix, and what each package's
whole `ransac_essential` gives on these inputs: its winner's count (which
the re-run stage must reproduce) and its count after the GN polish. The
rank-2 counts use the port's `sampson_error` in f32 against the
per-point band (threshold / fx * sigma).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from slamtpu.ops.epipolar import enforce_rank2 as j_rank2  # noqa: E402
from slamtpu.ops.epipolar import sampson_error as j_sampson  # noqa: E402
from slamtpu.ops.five_point import five_point_candidates as j_five  # noqa: E402
from slamtpu.ops.ransac import ransac_essential as j_ransac  # noqa: E402
from slamtpu.pipeline import vo as jvo  # noqa: E402
from slamtpu_torch import convert  # noqa: E402
from slamtpu_torch.feature.detector import detect_and_compute  # noqa: E402
from slamtpu_torch.feature.matcher import FeatureMatcher  # noqa: E402
from slamtpu_torch.odometry.camera import CameraIntrinsics  # noqa: E402
from slamtpu_torch.ops.epipolar import enforce_rank2 as t_rank2  # noqa: E402
from slamtpu_torch.ops.epipolar import sampson_error as t_sampson  # noqa: E402
from slamtpu_torch.ops.five_point import N_ROOT_SLOTS, _topk_first  # noqa: E402
from slamtpu_torch.ops.five_point import five_point_candidates as t_five  # noqa: E402
from slamtpu_torch.ops.ransac import _gather_rows  # noqa: E402
from slamtpu_torch.ops.ransac import ransac_essential as t_ransac  # noqa: E402
from slamtpu_torch.pipeline import vo as tvo  # noqa: E402
from test_ate import _ate_vs_oracle, _fair_forward_scene, _fair_scene  # noqa: E402

torch.set_num_threads(1)
CHUNK = 32


def _angles(run_a, run_b):
    """Per pair: rotation difference and translation-direction difference,
    degrees."""
    tr = np.einsum("tij,tij->t", run_a.rotations.astype(np.float64), run_b.rotations.astype(np.float64))
    rot = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    ta, tb = run_a.translations.astype(np.float64), run_b.translations.astype(np.float64)
    cos = np.sum(ta * tb, 1) / np.maximum(np.linalg.norm(ta, axis=1) * np.linalg.norm(tb, axis=1), 1e-30)
    return rot, np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


@jax.jit
def _jax_winner(u, n1, n2, mask, thresh_sq, inv_sigma):
    """The JAX package's ransac_essential up to its winner (5-point,
    per-octave weighted sampling, no prescore): (E, count, flat index)."""
    w = (inv_sigma * inv_sigma).astype(jnp.float32)
    u = jnp.exp(jnp.log(jnp.maximum(u, 1e-30)) / w[None, :])
    u = jnp.where(mask[None, :], u, -jnp.inf)
    _, idx = jax.lax.top_k(u, 5)
    cands, valid = j_five(n1[idx], n2[idx])
    hyps = cands.reshape(-1, 3, 3)
    inl = (j_sampson(hyps, n1[None], n2[None]) < thresh_sq) & mask[None, :]
    counts = jnp.where(valid.reshape(-1), jnp.sum(inl.astype(jnp.int32), axis=-1), -1)
    best = jnp.argmax(counts)
    return hyps[best], counts[best], best


def _port_winner(u, n1, n2, mask, thresh_sq, inv_sigma):
    """The port's ransac_essential up to its winner, the same stages."""
    w = (inv_sigma * inv_sigma).to(torch.float32)
    u = torch.exp(torch.log(torch.clamp(u, min=1e-30)) / w[None, :])
    u = torch.where(mask[None, :], u, torch.full_like(u, float("-inf")))
    idx = _topk_first(u, 5)
    cands, valid = t_five(_gather_rows(n1, idx), _gather_rows(n2, idx))
    hyps = cands.reshape(-1, 3, 3)
    inl = (t_sampson(hyps, n1[None], n2[None]) < thresh_sq) & mask[None, :]
    counts = torch.where(valid.reshape(-1), torch.sum(inl, dim=-1, dtype=torch.int32), -1)
    best = int(torch.argmax(counts))
    return hyps[best], int(counts[best]), best


_j_ransac = jax.jit(j_ransac, static_argnames=("config",))


def pair_report(scene, cam, cfg, jcfg, i: int, key, u_np: np.ndarray) -> str:
    """The rank-2 table of pair i (frames i -> i+1) on the port's points,
    with the pair's JAX key and its draws."""
    feats = detect_and_compute(torch.from_numpy(scene.frames[i : i + 2]), cfg.orb)
    matcher = FeatureMatcher()
    good = matcher.filter_good_matches(matcher.match_descriptors(
        feats.descriptors[0], feats.descriptors[1], feats.mask[0], feats.mask[1]), cfg.match_ratio)
    p1, p2 = feats.xy[0], feats.xy[1][good.train_idx]
    sigma = cfg.orb.scale_factor ** torch.maximum(feats.octave[0], feats.octave[1][good.train_idx]).float()
    n1, n2, mask = cam.normalize(p1), cam.normalize(p2), good.mask
    threshold = torch.tensor(cfg.ransac.threshold, dtype=torch.float32) / cam.fx
    thresh_sq = threshold ** 2 * sigma * sigma
    inv_sigma = 1.0 / torch.clamp(sigma, min=1e-6)
    jn1, jn2, jmask, jsigma = (jnp.asarray(x.numpy()) for x in (n1, n2, mask, sigma))

    def count(e):
        return int(((t_sampson(torch.as_tensor(np.asarray(e), dtype=torch.float32), n1, n2) < thresh_sq)
                    & mask).sum())

    je, jc, jb = _jax_winner(jnp.asarray(u_np), jn1, jn2, jmask, jnp.asarray(thresh_sq.numpy()),
                             jnp.asarray(inv_sigma.numpy()))
    te, tc, tb = _port_winner(torch.from_numpy(u_np), n1, n2, mask, thresh_sq, inv_sigma)
    # Each package's whole ransac_essential on the same inputs: its winner's
    # count (the stage above must reproduce it) and its count after the
    # GN polish.
    j_full = _j_ransac(key, jn1, jn2, mask=jmask, threshold_norm=jnp.asarray(threshold.numpy()), config=jcfg.ransac,
                      sigma=jsigma)
    t_full = t_ransac(n1, n2, mask=mask, threshold_norm=threshold, config=cfg.ransac, sigma=sigma,
                      uniforms=torch.from_numpy(u_np))
    rows = []
    for who, e, c, b, full in (("JAX", np.asarray(je), int(jc), int(jb), j_full), ("port", te.numpy(), tc, tb, t_full)):
        e_t = torch.from_numpy(np.asarray(e, np.float32))
        j_proj, t_proj = j_rank2(jnp.asarray(e)), t_rank2(e_t)
        own, other = (j_proj, t_proj) if who == "JAX" else (t_proj, j_proj)
        sv = np.linalg.svd(np.asarray(e, np.float64), compute_uv=False)
        move = float(np.abs(np.asarray(own, np.float64) - np.asarray(e, np.float64)).max())
        rows.append(f"    {who:4s} winner hypothesis {b // N_ROOT_SLOTS} slot {b % N_ROOT_SLOTS}: singular values "
                    f"({sv[0]:.4f}, {sv[1]:.4f}, {sv[2]:.4f}); Sampson inliers {c} (scored) / {count(e)} "
                    f"before rank-2, {count(own)} after its own enforce_rank2 (moves it by {move:.4f}), "
                    f"{count(other)} after the other package's; its whole ransac_essential: winner "
                    f"{int(full.best_iter_inliers)}, {int(full.num_inliers)} after the polish")
    return f"  pair {i}: {int(mask.sum())} matches\n" + "\n".join(rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("lateral", "forward"), default="forward")
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    scene = (_fair_scene if args.scene == "lateral" else _fair_forward_scene)(args.frames)
    i = scene.intrinsics
    cam = CameraIntrinsics(float(i.fx), float(i.fy), float(i.cx), float(i.cy))
    jcfg = jvo.VoConfig()
    cfg = convert.config_from_jax(jcfg)
    n_pairs = args.frames - 1
    keys = jax.random.split(jax.random.PRNGKey(args.seed), n_pairs)
    draws = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (cfg.ransac.iters, cfg.orb.max_features), dtype=jnp.float32))(keys))

    runs = {
        "JAX": jvo.run_vo(scene.frames, scene.intrinsics, jcfg, chunk_size=CHUNK, seed=args.seed),
        "port, JAX's draws": tvo.run_vo(scene.frames, cam, cfg, chunk_size=CHUNK, uniforms=draws, device="cpu",
                                        pose_dtype=torch.float64),
        "port, own draws": tvo.run_vo(scene.frames, cam, cfg, chunk_size=CHUNK, seed=args.seed, device="cpu",
                                      pose_dtype=torch.float64),
    }
    print(f"{args.scene} scene, {args.frames} frames, seed {args.seed}, VoConfig(), chunk {CHUNK}")
    for name, run in runs.items():
        common, _, ate, ate_oracle = _ate_vs_oracle(scene, run)
        print(f"  {name:18s}: {run.successful_frames}/{n_pairs} successes; ATE {ate:.3f} over {len(common)} "
              f"common steps = {ate / len(common):.4f} a step; oracle {ate_oracle:.3f}, ratio "
              f"{ate / max(ate_oracle, 1e-12):.3f}")

    ref, ours = runs["JAX"], runs["port, JAX's draws"]
    rot, trans = _angles(ref, ours)
    same_matches = int((ref.num_matches == ours.num_matches).sum())
    diff_inl = ref.num_inliers != ours.num_inliers
    flagged = np.nonzero(diff_inl | (rot > 0.1) | (trans > 1.0))[0]
    print(f"JAX vs port on JAX's draws: num_matches equal on {same_matches}/{n_pairs} pairs; inlier counts differ "
          f"on {int(diff_inl.sum())}; median rotation difference {np.median(rot):.4g} deg, median translation "
          f"direction difference {np.median(trans):.4g} deg; translations > 10 deg apart on "
          f"{int((trans > 10).sum())} pairs")
    print(f"{len(flagged)} pairs differ (inliers, rotation > 0.1 deg or translation > 1 deg):")
    for p in flagged:
        print(f"  pair {p}: inliers JAX {ref.num_inliers[p]} / port {ours.num_inliers[p]}, rotation "
              f"{rot[p]:.3f} deg, translation {trans[p]:.2f} deg apart")
    worst = flagged[np.argsort(-np.abs(ref.num_inliers[flagged].astype(int) - ours.num_inliers[flagged]))]
    print("rank-2 projection of each package's winner, on the port's points and the pair's JAX draws:")
    for p in worst:
        print(pair_report(scene, cam, cfg, jcfg, int(p), keys[p], draws[p]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
