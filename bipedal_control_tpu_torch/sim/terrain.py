"""Terrain height sampling for terrain-aware references (sim/terrain.py
counterpart, a copy: numpy, and MuJoCo at the raycast).

The reference hardcodes terrainHeight = 0 in its planner
(SwitchedModelReferenceManager.cpp:64-71) even though it ships a terrain
world (h1_description/mjcf/scene_terrain.xml) and its swing planner plumbs
per-phase lift-off/touch-down heights end to end
(SwingTrajectoryPlanner.cpp:66-118).  This module closes that loop: sample
the static world geometry of a MuJoCo scene into a host-side height map,
and hand the resulting ``height_at(x, y)`` callable to the
:class:`~..reference.manager.ReferenceManager` (``terrain_fn``), which
feeds it into swing splines and the base-z reference.

The height map lives on the HOST (it changes at world rate, not solve
rate) and is baked into the frozen per-replan reference tables: the solver
on the card never sees a raycast, only the spline/target tables it already
consumes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TerrainMap:
    """Bilinear-interpolated height grid z(x, y)."""

    x0: float
    y0: float
    res: float
    z: np.ndarray  # (nx, ny)

    def height_at(self, x: float, y: float) -> float:
        gx = np.clip((x - self.x0) / self.res, 0.0, self.z.shape[0] - 1.001)
        gy = np.clip((y - self.y0) / self.res, 0.0, self.z.shape[1] - 1.001)
        ix, iy = int(gx), int(gy)
        fx, fy = gx - ix, gy - iy
        z = self.z
        return float(
            z[ix, iy] * (1 - fx) * (1 - fy)
            + z[ix + 1, iy] * fx * (1 - fy)
            + z[ix, iy + 1] * (1 - fx) * fy
            + z[ix + 1, iy + 1] * fx * fy
        )

    __call__ = height_at


def terrain_from_mujoco(
    mj_model,
    x_range=(-2.0, 4.0),
    y_range=(-2.0, 2.0),
    resolution: float = 0.05,
    max_height: float = 5.0,
) -> TerrainMap:
    """Raycast the scene's STATIC world geometry into a TerrainMap.

    The robot is teleported far above the sampling volume in a scratch
    MjData before casting (rays start below it), so only world geometry —
    planes, boxes, height fields — is hit; the sim's own MjData is never
    touched."""
    import mujoco

    data = mujoco.MjData(mj_model)
    if mj_model.nq >= 7:  # free-joint robot: move it out of the ray volume
        data.qpos[2] = 1000.0
    mujoco.mj_forward(mj_model, data)

    nx = int(round((x_range[1] - x_range[0]) / resolution)) + 1
    ny = int(round((y_range[1] - y_range[0]) / resolution)) + 1
    z = np.zeros((nx, ny))
    geomid = np.zeros(1, dtype=np.int32)
    vec = np.array([0.0, 0.0, -1.0])
    for i in range(nx):
        for j in range(ny):
            pnt = np.array(
                [x_range[0] + i * resolution, y_range[0] + j * resolution, max_height]
            )
            dist = mujoco.mj_ray(mj_model, data, pnt, vec, None, 1, -1, geomid)
            z[i, j] = max_height - dist if dist >= 0.0 else 0.0
    return TerrainMap(x0=x_range[0], y0=y_range[0], res=resolution, z=z)
