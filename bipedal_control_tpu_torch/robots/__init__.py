"""Robot registry: locate description/config assets for the supported robots
(robots/__init__.py counterpart: the same registry; ``configs/`` is found
relative to the repository).

The framework is robot-agnostic (like the reference's C++ layers); per-robot
URDF/config assets are supplied by the user.  By default we look for a
reference-layout asset tree at $BIPEDAL_ASSETS (or the JAX package's
default root), matching the four robots the reference ships: Unitree H1, OpenLoong, Hunter, Unitree G1
(bipedal_robot_example/, SURVEY.md §2 items 31-34).
"""
from __future__ import annotations

import dataclasses
import os

ASSET_ROOT = os.environ.get(
    "BIPEDAL_ASSETS", os.environ.get("BIPEDAL_REFERENCE_ASSETS", "/root/reference")
)


@dataclasses.dataclass(frozen=True)
class RobotAssets:
    name: str
    urdf: str
    task_info: str | None
    reference_info: str | None
    gait_info: str | None
    mjcf: str | None = None
    # optional .info overlay applied on top of task.info (declarative
    # dynamic-reconfigure: runtime-tuned knobs live in a file, logged on load)
    overrides_info: str | None = None
    # optional authored gait supplements merged over the reference gait.info
    extra_gait_info: str | None = None

    def exists(self) -> bool:
        return os.path.exists(self.urdf)


def _local_config(rel: str) -> str:
    return os.path.join(os.path.dirname(__file__), "../../configs", rel)


def _example(rel: str) -> str:
    return os.path.join(ASSET_ROOT, "bipedal_robot_example", rel)


REGISTRY: dict[str, RobotAssets] = {
    "h1": RobotAssets(
        name="h1",
        urdf=_example("unitree_h1/h1_description/urdf/h1_with_sole.urdf"),
        task_info=_example("unitree_h1/h1_ocs2_config/config/task/task.info"),
        reference_info=_example("unitree_h1/h1_ocs2_config/config/command/reference.info"),
        gait_info=_example("unitree_h1/h1_ocs2_config/config/command/gait.info"),
        mjcf=_example("unitree_h1/h1_description/mjcf/scene.xml"),
        overrides_info=_local_config("h1/overrides.info"),
    ),
    "hunter": RobotAssets(
        name="hunter",
        urdf=_example("hunter/legged_hunter_description/urdf/hunter.urdf"),
        task_info=_example("hunter/legged_hunter_config/config/task/task.info"),
        reference_info=_example("hunter/legged_hunter_config/config/command/reference.info"),
        gait_info=_example("hunter/legged_hunter_config/config/command/gait.info"),
        overrides_info=_local_config("hunter/overrides.info"),
        extra_gait_info=_local_config("hunter/extra_gaits.info"),
    ),
    "openloong": RobotAssets(
        name="openloong",
        urdf=_example("openloong_description/urdf/AzureLoong_with_sole.urdf"),
        task_info=_example("openloong_description/config/task/task.info"),
        reference_info=_example("openloong_description/config/command/reference.info"),
        gait_info=_example("openloong_description/config/command/gait.info"),
        mjcf=_example("openloong_description/mjcf/scene.xml"),
        overrides_info=_local_config("openloong/overrides.info"),
        extra_gait_info=_local_config("openloong/extra_gaits.info"),
    ),
    "g1": RobotAssets(
        name="g1",
        urdf=_example("unitree_g1/g1_description/g1.urdf"),
        # the reference ships description only (SURVEY §2 item 34); this repo
        # authors the missing task configs under configs/g1/
        task_info=os.path.join(os.path.dirname(__file__), "../../configs/g1/g1_task.info"),
        reference_info=os.path.join(os.path.dirname(__file__), "../../configs/g1/g1_reference.info"),
        gait_info=os.path.join(os.path.dirname(__file__), "../../configs/g1/g1_gaits.info"),
        mjcf=_example("unitree_g1/g1_description/scene.xml"),
        overrides_info=_local_config("g1/overrides.info"),
    ),
}


def get_assets(name: str) -> RobotAssets:
    return REGISTRY[name]
