"""PyTorch port vs JAX reference: gait schedules, frozen gait tables and
swing splines (gait/mode_schedule.py, gait/swing.py), float64 on the CPU.

The host side (tiling, insertion, leg logic, spline planning) is the same
numpy code in both packages and must agree exactly; the device tables'
queries take a tensor of times in the port and are held against the
reference's per-time queries at random times to 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.config.loader import load_task_config as j_load_task_config
from bipedal_control_tpu.gait import mode_schedule as jms
from bipedal_control_tpu.gait import swing as jsw
from bipedal_control_tpu_torch.gait import mode_schedule as ms
from bipedal_control_tpu_torch.gait import swing as sw

from test_torch_config import G1_ARGS

MAX_PHASES = 32


def _schedules():
    """Pairs of (port, reference) GaitSchedules driven through the same
    insertions and tilings over G1's gait library."""
    cfg = j_load_task_config(*G1_ARGS)
    out = []
    for first, second, t_switch in (("trot", "standing_trot", 1.3), ("slow_walk", "flying_trot", 0.9),
                                    ("standing_trot", "stance", 2.0)):
        pair = []
        for mod in (ms, jms):
            init = mod.ModeSchedule(list(cfg.initial_mode_schedule.event_times),
                                    list(cfg.initial_mode_schedule.mode_sequence))
            tpl = lambda n: mod.ModeSequenceTemplate(list(cfg.gait_library[n].switching_times),
                                                     list(cfg.gait_library[n].mode_sequence))
            gs = mod.GaitSchedule(init, tpl("stance"), cfg.phase_transition_stance_time)
            gs.insert_mode_sequence_template(tpl(first), 0.1, 1.1)
            gs.get_mode_schedule(-1.0, 2.0)
            gs.insert_mode_sequence_template(tpl(second), t_switch, t_switch + 1.0)
            pair.append(gs.get_mode_schedule(t_switch - 1.0, t_switch + 2.0))
        out.append(tuple(pair))
    return out


SCHEDULES = _schedules()


@pytest.mark.parametrize("k", range(len(SCHEDULES)))
def test_schedule_tiling_and_insertion_match_reference(k):
    got, want = SCHEDULES[k]
    assert got.event_times == want.event_times
    assert got.mode_sequence == want.mode_sequence
    t = np.linspace(got.event_times[0] - 0.2, got.event_times[-1] + 0.2, 23)
    assert [got.mode_at(x) for x in t] == [want.mode_at(x) for x in t]
    for leg_fn in ("get_contact_phase_per_leg", "get_swing_phase_per_leg"):
        for x in t:
            np.testing.assert_array_equal(np.array(getattr(ms, leg_fn)(x, got)),
                                          np.array(getattr(jms, leg_fn)(x, want)))
    for a, b in zip(ms.extract_contact_timings_per_leg(got), jms.extract_contact_timings_per_leg(want)):
        np.testing.assert_array_equal(np.array(a), np.array(b))


@pytest.mark.parametrize("k", range(len(SCHEDULES)))
def test_gait_table_queries_match_reference(k):
    """freeze_mode_schedule's tables, then phase_index, mode_at,
    contact_flags_at and the next touch-down / lift-off per leg at random
    times (the port in one call over all times)."""
    got_s, want_s = SCHEDULES[k]
    table = ms.freeze_mode_schedule(got_s, MAX_PHASES, device="cpu")
    ref = jms.freeze_mode_schedule(want_s, MAX_PHASES)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(table, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    rng = np.random.default_rng(k)
    times = np.concatenate([rng.uniform(got_s.event_times[0] - 0.3, got_s.event_times[-1] + 0.3, 64),
                            np.array(got_s.event_times)])  # the events themselves: side="right"
    tt = torch.as_tensor(times)
    for query in ("phase_index", "mode_at", "contact_flags_at", "next_touchdown_per_leg", "next_liftoff_per_leg"):
        want = np.asarray(jax.vmap(getattr(ref, query))(jnp.asarray(times)))
        np.testing.assert_allclose(getattr(table, query)(tt).numpy(), want, rtol=0, atol=1e-12, err_msg=query)
    # one time at a time (0-d) gives the same per-leg answers
    np.testing.assert_array_equal(table.next_touchdown_per_leg(tt[3]).numpy(),
                                  np.asarray(ref.next_touchdown_per_leg(times[3])))


@pytest.mark.parametrize("k", range(len(SCHEDULES)))
def test_swing_table_matches_reference(k):
    """plan_swing_table's coefficients, and z_position / z_velocity at
    random times for every contact with the gait table's phase, to 1e-12."""
    got_s, want_s = SCHEDULES[k]
    cfg = jsw.SwingConfig(lift_off_velocity=0.05, swing_height=0.06, swing_time_scale=0.15)
    pcfg = sw.SwingConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    rng = np.random.default_rng(10 + k)
    n = len(want_s.mode_sequence)
    lift, touch = rng.uniform(0.0, 0.05, (4, n)), rng.uniform(0.0, 0.05, (4, n))
    for heights in ({}, {"lift_off_heights": lift, "touch_down_heights": touch}):
        table = sw.plan_swing_table(pcfg, got_s, MAX_PHASES, device="cpu", **heights)
        ref = jsw.plan_swing_table(cfg, want_s, MAX_PHASES, **heights)
        np.testing.assert_array_equal(table.coeffs.numpy(), np.asarray(ref.coeffs))
        np.testing.assert_array_equal(table.mid_times.numpy(), np.asarray(ref.mid_times))
        gait = jms.freeze_mode_schedule(want_s, MAX_PHASES)
        times = rng.uniform(want_s.event_times[0], want_s.event_times[-1], 48)
        phases = np.asarray(jax.vmap(gait.phase_index)(jnp.asarray(times)))
        contacts = np.arange(4)
        tq, pq = torch.as_tensor(times)[:, None], torch.as_tensor(phases.copy())[:, None]
        pos, vel = table.z_position_velocity(torch.arange(4), pq, tq)
        for name, got in (("z_position", table.z_position(torch.arange(4), pq, tq)), ("z_velocity", vel),
                          ("z_position", pos), ("z_velocity", table.z_velocity(torch.arange(4), pq, tq))):
            fn = getattr(ref, name)
            want = np.asarray(jax.vmap(lambda t, p: jnp.stack([fn(c, p, t) for c in contacts]))(
                jnp.asarray(times), jnp.asarray(phases)))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12, err_msg=name)
