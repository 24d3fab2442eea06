"""What Python hands the circuit kernels (csrc/centroidal_circuit.cuh)
besides the parameter buffer: the tree's level schedule, by which the
kernels compose the FK frames one level at a time, and the group width,
the lanes per instance.  CPU only; the kernels' own checks are the
gpu-marked tests of tests/test_torch_kernels.py."""
import dataclasses

import numpy as np
import pytest

from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.model.centroidal import make_info
from bipedal_control_tpu_torch.model.robot_model import from_description
from bipedal_control_tpu_torch.ops.static_model import (
    group_width,
    joint_levels,
    kernel_defines,
    level_schedule,
    make_static_model,
)

from chip_smoke import H1_CONTACTS, h1_shaped_description
from test_pallas_linearize_kernel import tiny_biped


def _tiny():
    model, info = tiny_biped()
    tm = convert.model_from_numpy(
        {f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)}, device="cpu"
    )
    return make_static_model(tm, convert.info_from_numpy(dataclasses.asdict(info)).contact_frame_ids)


def _h1_shaped():
    model = from_description(h1_shaped_description(), device="cpu")
    return make_static_model(model, make_info(model, H1_CONTACTS).contact_frame_ids)


# The defines each kernel build gets: the tiny biped (two legs of two
# joints, the right shank prismatic) and the H1-shaped biped (two 5-joint
# legs on the base).  Both have at most 16 coordinates: one 16-lane group
# per instance, two instances per warp.
EXPECTED = {
    "tiny": {
        "NJ": "4", "PARENT_LIST": "0,1,0,3", "JTYPE_LIST": "0,0,0,1", "CONTACT_BODY_LIST": "2,2,4,4",
        "NLEVELS": "2", "LEVEL_ORDER": "0,2,1,3", "LEVEL_START": "0,2,4", "GROUP": "16",
    },
    "h1_shaped": {
        "NJ": "10", "PARENT_LIST": "0,1,2,3,4,0,6,7,8,9", "JTYPE_LIST": "0,0,0,0,0,0,0,0,0,0",
        "CONTACT_BODY_LIST": "5,5,10,10", "NLEVELS": "5", "LEVEL_ORDER": "0,5,1,6,2,7,3,8,4,9",
        "LEVEL_START": "0,2,4,6,8,10", "GROUP": "16",
    },
}
ROBOTS = {"tiny": _tiny, "h1_shaped": _h1_shaped}


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_kernel_defines_of_the_test_robots(robot):
    assert kernel_defines(ROBOTS[robot]()) == EXPECTED[robot]


@pytest.mark.parametrize(
    "parent",
    [[0, 1, 0, 3], [0, 1, 2, 3, 4, 0, 6, 7, 8, 9], [0, 0, 1, 1, 2, 3, 0], [0]],
    ids=["tiny", "h1_shaped", "branching", "one_joint"],
)
def test_level_schedule_follows_the_tree(parent):
    """Each joint sits one level below the joint that moves its parent body
    (level 0 on the base); the schedule lists every joint once, level by
    level, and LEVEL_START cuts it at the level boundaries."""
    levels = joint_levels(parent)
    for j, par in enumerate(parent):
        assert levels[j] == (0 if par == 0 else levels[par - 1] + 1)
    order, start = level_schedule(parent)
    assert sorted(order) == list(range(len(parent)))
    assert start[0] == 0 and start[-1] == len(parent) and len(start) == max(levels) + 2
    for d in range(len(start) - 1):
        assert all(levels[j] == d for j in order[start[d]:start[d + 1]])
    seen = set()
    for j in order:  # a parent's frame is composed before its children's
        assert parent[j] == 0 or parent[j] - 1 in seen
        seen.add(j)


def test_level_schedule_rejects_a_parent_after_its_child():
    with pytest.raises(ValueError):
        joint_levels([0, 3, 0, 0])


@pytest.mark.parametrize("nv,lanes", [(7, 16), (10, 16), (16, 16), (17, 32), (18, 32), (32, 32)])
def test_group_width_is_the_next_power_of_two(nv, lanes):
    assert group_width(nv) == lanes


def test_group_width_refuses_more_than_a_warp():
    with pytest.raises(NotImplementedError):
        group_width(33)
