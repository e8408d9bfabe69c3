"""Small versions of the cells, for runs on the CPU: the same files as the
cells', with the image, the scene, the feature budget and the map cut to a
size a test can hold."""

from __future__ import annotations

import copy

from benchmark import settings

IMAGE = {"height": 120, "width": 200}
CAMERA = {"fx": 180.0, "fy": 180.0, "cx": 100.0, "cy": 60.0}
SCENE = {"frames": 17, "landmarks": 300, "step": 0.8, "noise": 2.0, "textured": True}
# The ground-truth gates are the full size's (KITTI's resolution, 500
# features); at 120x200 with 96 features on 9-17 frames the poses are
# coarser (median rotation errors of 0.6-2.6 degrees), so the small files
# hold those numbers here. Every other limit is the cell's own.
SMALL_GT = {"gt_fail_share": 0.5, "gt_rot_err_p50_deg": 5.0, "gt_kf_rot_err_p50_deg": 5.0}


def files(cell_name: str):
    """(spec, config, traffic, limits) of a cell, cut to the small size."""
    spec = copy.deepcopy(settings.spec())
    cell = settings.cell(spec, cell_name)
    config = copy.deepcopy(settings.config_file(spec, cell["config"]))
    traffic = copy.deepcopy(settings.traffic_file(cell["traffic"]))
    config["image"], config["camera"] = dict(IMAGE), dict(CAMERA)
    vo = config["vo"] if "vo" in config else config["point_cloud"]["vo"]
    vo["orb"].update(max_features=96, n_levels=3)
    if "point_cloud" in config:
        config["point_cloud"].update(map_capacity=1024, max_obs_per_kf=96, max_ba_observations=512,
                                     max_ba_landmarks=256)
    traffic["scene"] = dict(SCENE)
    if traffic["mode"] == "batch":
        traffic.update(clip_frames=9, offsets=[0, 3, 6, 8], chunk_size=4)
    else:
        traffic.update(clip_frames=17, chunk_size=8)
    limits = copy.deepcopy(settings.limits_file(cell_name))
    limits["limits"].update({k: v for k, v in SMALL_GT.items() if k in limits["limits"]})
    return spec, config, traffic, limits
