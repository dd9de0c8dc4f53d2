"""Scenes and cameras made from a run's seed.

The scene arrays follow the repo's bench recipe (points in a ball of
standard deviation 2.2, SH coefficients N(0, 0.2), logit opacities N(0, 1),
random quaternions, per-axis scales in [0.002, 0.01)); the numbers are the
configuration file's. They are drawn on the
device from one ``torch.Generator`` in a few large calls. Cameras are drawn
on the host from the seed: orbits about the origin, looking at it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import Cam

FIELDS = ("colors_sh", "opacities", "positions", "rotations", "scalings")


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def ball_scene(spec: dict, points: int, gen: torch.Generator, device) -> dict:
    """The ball scene: inner parameters, float32 on ``device``."""
    normal = torch.randn((points, 3 + 48 + 1 + 4), generator=gen, device=device)
    unit = torch.rand((points, 3), generator=gen, device=device)
    return dict(
        positions=normal[:, 0:3] * spec["position_std"],
        colors_sh=normal[:, 3:51] * spec["sh_std"],
        opacities=normal[:, 51:52] * spec["opacity_logit_std"],
        rotations=normal[:, 52:56].contiguous(),
        scalings=torch.log(spec["scale_min"] + spec["scale_span"] * unit),
    )


def make_scene(config: dict, seed: int, device) -> tuple[dict, torch.Generator]:
    gen = generator(seed, device)
    spec = config["scene"]
    return ball_scene(spec, config["points"], gen, device), gen


def noisy_start(params: dict, spec: dict, gen: torch.Generator) -> dict:
    """A training start near ``params``: the DC colours, the logit opacities
    and the positions moved by seeded noise (the configuration's ``start``)."""
    start = {k: v.clone() for k, v in params.items()}
    p = start["positions"].shape[0]
    noise = torch.randn((p, 6), generator=gen, device=start["positions"].device)
    start["colors_sh"][:, :3] += noise[:, :3] * spec["dc_std"]
    start["opacities"] += spec["opacity_shift"]
    start["positions"] += noise[:, 3:] * spec["position_std"]
    return start


def orbit(yaw: float, pitch: float, camera: dict, width: int, height: int) -> Cam:
    """The camera ``camera["distance"]`` behind the origin looking at it,
    turned by ``yaw`` / ``pitch`` radians about the origin."""
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
    turn = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]]) @ np.array(
        [[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    position = turn @ np.array([0.0, 0.0, -camera["distance"]])
    rotation = turn.T
    return Cam(rotation=rotation, translation=-rotation @ position, position=position,
               fov=(camera["fov_x"], camera["fov_y"]), width=width, height=height)


def orbit_pool(config: dict, count: int, spread: float, seed: int) -> list:
    """``count`` cameras with yaw and pitch uniform in [-spread, spread]."""
    rng = host_rng(seed, 1)
    angles = rng.uniform(-spread, spread, (count, 2))
    return [orbit(float(y), float(p), config["camera"], config["width"], config["height"])
            for y, p in angles]


def to_view(T, cam: Cam):
    """The program's ``View`` of a reference camera (column-major transform)."""
    return T.View(field_of_view_x=cam.fov[0], field_of_view_y=cam.fov[1],
                  image_height=cam.height, image_width=cam.width,
                  view_position=np.asarray(cam.position, np.float64),
                  view_transform=T.View.transform(np.asarray(cam.rotation).T, cam.translation))
