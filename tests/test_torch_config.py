"""PyTorch port vs JAX reference: the .info parser, the task-config loader,
the robot registry and the OCP settings factory, on G1's configuration files
(configs/g1/*, which parse without the asset tree).

The port keeps its own copies of these host modules; every parsed field must
equal the reference's (numbers to 1e-12, everything else exactly).
"""
import dataclasses
import os

import numpy as np
import pytest

from bipedal_control_tpu import robots as j_robots
from bipedal_control_tpu.config import loader as j_loader
from bipedal_control_tpu.interface import ocp_settings_from_task as j_ocp_settings_from_task
from bipedal_control_tpu.utils import info_format as j_info
from bipedal_control_tpu_torch import robots
from bipedal_control_tpu_torch.config import loader
from bipedal_control_tpu_torch.interface import ocp_settings_from_task
from bipedal_control_tpu_torch.utils import info_format

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1 = {f: os.path.join(REPO, "configs", "g1", f)
      for f in ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info")}
G1_ARGS = (G1["g1_task.info"], G1["g1_reference.info"], G1["g1_gaits.info"], G1["overrides.info"])


def _assert_same(got, want, path="cfg"):
    """Recursive equality of parsed values: dataclasses field by field,
    arrays to 1e-12, containers element by element, the rest exactly."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            _assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, err_msg=path)
    elif isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


@pytest.mark.parametrize("name", sorted(G1))
def test_parse_info_matches_reference(name):
    with open(G1[name]) as f:
        text = f.read()
    assert info_format.parse_info(text) == j_info.parse_info(text)


def test_info_getters_match_reference():
    tree = info_format.load_info(G1["g1_task.info"])
    for fn, args in (
        ("get_string_list", ("model_settings.jointNames",)),
        ("get_string_list", ("model_settings.upperJointNames",)),
        ("get_scalar", ("sqp.dt",)),
        ("get_bool", ("sqp.useFeedbackPolicy",)),
        ("get_string", ("sqp.integratorType",)),
        ("get_matrix", ("Q", 24, 24)),
        ("get_matrix", ("initialState", 24)),
        ("get_node", ("extra_frames",)),
    ):
        _assert_same(getattr(info_format, fn)(tree, *args), getattr(j_info, fn)(tree, *args), f"{fn}{args}")
    for fn in (info_format.get_scalar, info_format.get_bool, info_format.get_string):
        with pytest.raises(KeyError):
            fn(tree, "no.such.key")


def test_load_task_config_matches_reference():
    """Every field of G1's TaskConfig: Q, R_task, the initial state, the
    gait library, the swing, ipm, ddp, wbc, mpc and sqp blocks, the sole
    frames and the (absent) capture block, with overrides.info applied."""
    got, want = loader.load_task_config(*G1_ARGS), j_loader.load_task_config(*G1_ARGS)
    _assert_same(got, want)
    assert got.Q.shape == (24, 24) and got.R_task.shape == (24, 24) and got.initial_state[8] == 0.665
    assert sorted(got.gait_library) == ["flying_trot", "slow_walk", "stance", "standing_trot", "trot"]
    assert got.wbc.weight_base_accel == 10.0  # overrides.info
    assert got.capture is None
    _assert_same(ocp_settings_from_task(got), j_ocp_settings_from_task(want))


def test_capture_and_hard_cone_blocks_match_reference(tmp_path):
    """A captureStepping block (touchdownSync, weightShift) and the hard-cone
    selection with its ipm binding, through an overrides file."""
    ov = tmp_path / "overrides.info"
    ov.write_text(
        "captureStepping\n{\n  hipRollLeft left_hip_roll_joint\n  hipRollRight right_hip_roll_joint\n"
        "  kp 0.8\n  kv 0.3\n  maxOffset 0.2\n  sign -1.0\n  decay 0.3\n  posDeadband 0.04\n"
        "  velDeadband 0.12\n  touchdownSync true\n  weightShift 0.02\n}\n"
        "bipedal_robot_interface\n{\n  useAnalyticalGradientsConstraints true\n}\n"
        "ipm\n{\n  ipmIteration 3\n  barrierLinearDecreaseFactor 0.3\n}\n"
        "sqp\n{\n  sqpIteration 2\n}\nmatmulPrecision float32\n"
    )
    args = G1_ARGS[:3] + (str(ov),)
    got, want = loader.load_task_config(*args), j_loader.load_task_config(*args)
    _assert_same(got, want)
    assert got.capture.left_index == 1 and got.capture.touchdown_sync and got.cone_mode == "hard"
    s = ocp_settings_from_task(got)
    _assert_same(s, j_ocp_settings_from_task(want))
    assert (s.cone, s.sqp_iterations, s.cone_mu_decay) == ("hard", 3, 0.3)


def test_robot_registry_matches_reference():
    assert list(robots.REGISTRY) == list(j_robots.REGISTRY)
    for name, want in j_robots.REGISTRY.items():
        got = robots.get_assets(name)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (a is None and b is None) or os.path.realpath(a) == os.path.realpath(b), (name, f.name)
    g1 = robots.get_assets("g1")
    for f in ("task_info", "reference_info", "gait_info", "overrides_info"):
        assert os.path.realpath(getattr(g1, f)) == os.path.realpath(G1[os.path.basename(getattr(g1, f))])
