"""PyTorch port vs JAX reference: SingleRigidBodyDynamics (centroidalModelType
1), the autodiff linearization and the second-order kinematics oracles,
float64 on the CPU.

SRBD evaluates the momentum matrix and the com at the nominal joint pose,
with zero joint columns, while the contact kinematics use the true joints.
On the synthetic biped (SRBD with a nonzero nominal pose) and on G1's
configuration (configs/g1/* on tests/data/g1_shaped_biped.urdf, SRBD at its
initial joint state, as make_interface builds it from centroidalModelType
1), four nodes over every contact mode: the structured linearization
against the reference's (euler, rk2 and rk2 with the exact sensitivity; both
packages raise for rk4), node_eval against the reference's (euler, rk2, and
rk4, which both evaluate with RK2: the reference's else branch), and the
autodiff linearize_node (torch.func.jacfwd over discrete_dynamics) against
the structured one where the two are the same function (euler, rk2 exact),
at 1e-9 relative to max(1, |ref|); on the synthetic biped also the autodiff
linearize_node against the reference's for euler, rk2 and rk4 (the
reference's jacfwd of G1's dynamics compiles for ~25-75 s per integrator).  One SRBD SQP iteration (structured, sequential, xla) on the
synthetic biped's batched problem against the reference's vmap(sqp_solve)
at the batched-parity bars.  The oracles of model/second_order.py
(point_jacobian_derivatives, cmm_derivative, cmm_derivative_fast,
cmm_v_derivative) and ocp/linearize.py's _terms_and_dq_ad against the
reference's at 1e-10, on the synthetic biped.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bipedal_control_tpu.interface import make_interface as j_make_interface
from bipedal_control_tpu.model import kinematics as jk
from bipedal_control_tpu.model import second_order as jso
from bipedal_control_tpu.ocp import linearize as jl
from bipedal_control_tpu.ocp import problem as jp
from bipedal_control_tpu_torch import convert
from bipedal_control_tpu_torch.model import kinematics as tk
from bipedal_control_tpu_torch.model import second_order as tso
from bipedal_control_tpu_torch.model.centroidal import centroidal_momentum_matrix_info
from bipedal_control_tpu_torch.ocp import linearize as tl
from bipedal_control_tpu_torch.ocp import problem as tp

from test_pallas_linearize_kernel import _nodes, tiny_biped
from test_torch_model import _check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G1_URDF = os.path.join(REPO, "tests", "data", "g1_shaped_biped.urdf")
G1_FILES = tuple(os.path.join(REPO, "configs", "g1", f) for f in
                 ("g1_task.info", "g1_reference.info", "g1_gaits.info", "overrides.info"))
T = lambda a: torch.as_tensor(np.array(a))


def _port(model, info):
    tm = convert.model_from_numpy({f.name: np.asarray(getattr(model, f.name)) for f in dataclasses.fields(model)},
                                  device="cpu")
    return tm, convert.info_from_numpy(dataclasses.asdict(info))


@pytest.fixture(scope="module", params=["tiny", "g1"])
def robot(request):
    """(reference model, SRBD info, port model, port SRBD info, nodes, Q, R)."""
    if request.param == "tiny":
        model, info = tiny_biped()
        info = dataclasses.replace(info, model_type=1, q_j_nominal=(0.1, -0.2, 0.15, 0.05))
        rng = np.random.default_rng(5)
    else:
        j_iface = j_make_interface(G1_URDF, *G1_FILES)
        model = j_iface.model
        info = dataclasses.replace(j_iface.info, model_type=1,
                                   q_j_nominal=tuple(float(v) for v in np.asarray(j_iface.initial_state)[12:]))
        rng = np.random.default_rng(6)
    tm, ti = _port(model, info)
    nodes = _nodes(info, rng)
    Q = np.diag(rng.uniform(1.0, 10.0, info.state_dim))
    R = np.diag(rng.uniform(0.01, 1.0, info.input_dim))
    return model, info, tm, ti, nodes, Q, R


def _port_nodes(nodes):
    xs, us, xns, refs = nodes
    return T(xs), T(us), T(xns), convert.refs_from_numpy({k: np.asarray(v) for k, v in refs._asdict().items()},
                                                         device="cpu")


def _settings(integrator, exact=False):
    js = jp.OcpSettings(position_error_gain=0.3, integrator=integrator, exact_rk2_sensitivity=exact)
    return js, convert.settings_from_numpy(dataclasses.asdict(js))


def _ref(fn, model, info, js, Q, R, nodes):
    return jax.jit(jax.vmap(lambda x, u, xn, r: fn(model, info, js, jnp.asarray(Q), jnp.asarray(R), x, u, xn, r)))(
        *nodes)


def test_srbd_momentum_matrix(robot):
    """Zero joint columns, the base block at the nominal joints."""
    model, info, tm, ti, nodes, _, _ = robot
    from bipedal_control_tpu.model.centroidal import centroidal_momentum_matrix_info as j_cmm

    q = nodes[0][:, 6:]
    got = centroidal_momentum_matrix_info(tm, ti, T(q))
    _check("A", got, jax.vmap(lambda qq: j_cmm(model, info, qq))(q), 1e-12)
    assert bool((got[..., 6:] == 0).all())


@pytest.mark.parametrize("integrator,exact", [("euler", False), ("rk2", False), ("rk2", True)])
def test_srbd_structured_linearization_matches_reference(robot, integrator, exact):
    model, info, tm, ti, nodes, Q, R = robot
    js, ts = _settings(integrator, exact)
    ref = _ref(jl.linearize_node_structured, model, info, js, Q, R, nodes)
    got = tl.linearize_node_structured(tm, ti, ts, T(Q), T(R), *_port_nodes(nodes))
    for f in got._fields:
        _check(f, getattr(got, f), getattr(ref, f), 1e-9)
    with pytest.raises(NotImplementedError):
        tl.linearize_node_structured(tm, ti, _settings("rk4")[1], T(Q), T(R), *_port_nodes(nodes))


@pytest.mark.parametrize("integrator", ["euler", "rk2", "rk4"])
def test_srbd_node_eval_matches_reference(robot, integrator):
    model, info, tm, ti, nodes, Q, R = robot
    js, ts = _settings(integrator)
    ref = _ref(jl.node_eval, model, info, js, Q, R, nodes)
    got = tl.node_eval(tm, ti, ts, T(Q), T(R), *_port_nodes(nodes))
    for name, g, r in zip(("cost", "defect", "eq"), got, ref):
        _check(name, g, r, 1e-9)


@pytest.fixture(scope="module")
def tiny():
    """The synthetic biped's (reference model, SRBD info, port model, port
    info, nodes, Q, R)."""
    model, info = tiny_biped()
    info = dataclasses.replace(info, model_type=1, q_j_nominal=(0.1, -0.2, 0.15, 0.05))
    rng = np.random.default_rng(5)
    tm, ti = _port(model, info)
    nodes = _nodes(info, rng)
    return model, info, tm, ti, nodes, np.diag(rng.uniform(1.0, 10.0, info.state_dim)), np.diag(
        rng.uniform(0.01, 1.0, info.input_dim))


@pytest.mark.parametrize("integrator", ["euler", "rk2", "rk4"])
def test_autodiff_linearize_node_matches_reference(tiny, integrator):
    """linearize_node by torch.func against the reference's jax.jacfwd, on
    the synthetic biped with the SRBD model (the reference's jacfwd of G1's
    dynamics compiles for ~25-75 s per integrator; G1 is held by the next
    test)."""
    model, info, tm, ti, nodes, Q, R = tiny
    js, ts = _settings(integrator)
    ref = _ref(jp.linearize_node, model, info, js, Q, R, nodes)
    got = tp.linearize_node(tm, ti, ts, T(Q), T(R), *_port_nodes(nodes))
    for f in got._fields:
        _check(f, getattr(got, f), getattr(ref, f), 1e-9)


@pytest.mark.parametrize("integrator", ["euler", "rk2"])
def test_autodiff_linearize_node_matches_structured(robot, integrator):
    """The autodiff linearize_node against the structured linearization where
    both compute the same Jacobians (euler, and rk2 with the exact
    sensitivity), which the tests above hold against the reference; rk4
    runs (the structured path and the kernel refuse it) and is finite."""
    _, _, tm, ti, nodes, Q, R = robot
    args = (T(Q), T(R), *_port_nodes(nodes))
    got = tp.linearize_node(tm, ti, _settings(integrator)[1], *args)
    st = tl.linearize_node_structured(tm, ti, _settings(integrator, exact=True)[1], *args)
    for f in st._fields:
        _check(f, getattr(got, f), getattr(st, f), 1e-9)
    if integrator == "rk2":
        rk4 = tp.linearize_node(tm, ti, _settings("rk4")[1], *args)
        assert all(bool(torch.isfinite(t).all()) for t in rk4)


def test_srbd_sqp_iteration_matches_reference():
    """One SRBD SQP iteration (structured, sequential, xla; the linearize and
    merit kernels refuse SRBD, as the reference's do) on the synthetic
    biped's batched problem against the reference's vmap(sqp_solve)."""
    from bipedal_control_tpu.solver.sqp import sqp_solve as j_sqp_solve
    from bipedal_control_tpu_torch.parallel.batch_solver import make_batched_solver

    from test_lanes_rti import _batched_problem

    model, info = tiny_biped()
    info = dataclasses.replace(info, model_type=1, q_j_nominal=(0.1, -0.2, 0.15, 0.05))
    refs, t_nodes, x_init, xs, us = _batched_problem(model, info)
    Q, R = np.diag(np.linspace(1.0, 3.0, info.state_dim)), np.diag(np.linspace(0.1, 0.5, info.input_dim))
    settings = jp.OcpSettings(position_error_gain=0.35, linesearch_alphas=(1.0, 0.5))
    ref = jax.jit(jax.vmap(lambda r, t, x, a, u: j_sqp_solve(
        model, info, settings, jnp.asarray(Q), jnp.asarray(R), r, t, x, a, u)))(refs, t_nodes, x_init, xs, us)
    tm, ti = _port(model, info)
    ts = convert.settings_from_numpy(dataclasses.asdict(settings))
    got = make_batched_solver(tm, ti, ts, Q, R, device="cpu")(
        convert.refs_from_numpy({k: np.asarray(v) for k, v in refs._asdict().items()}, device="cpu"),
        T(t_nodes), T(x_init), T(xs), T(us))
    for name, bar in (("x_traj", 1e-5), ("u_traj", 1e-5), ("K", 1e-3), ("cost", 1e-5), ("defect_norm", 1e-5),
                      ("eq_norm", 1e-5)):
        _check(name, getattr(got, name), getattr(ref, name), bar)
    np.testing.assert_array_equal(got.step_size.numpy(), np.asarray(ref.step_size))
    for kernel in ({"linearize": "pallas"}, {"merit": "pallas"}):
        with pytest.raises(NotImplementedError):
            make_batched_solver(tm, ti, dataclasses.replace(ts, **kernel), Q, R, device="cpu")(
                convert.refs_from_numpy({k: np.asarray(v) for k, v in refs._asdict().items()}, device="cpu"),
                T(t_nodes), T(x_init), T(xs), T(us))


def _rand_q(model, rng):
    return np.concatenate([rng.uniform(-1, 1, 3), rng.uniform(-0.7, 0.7, 3), rng.uniform(-0.8, 0.8, model.nj)])


def test_second_order_oracles_match_reference(tiny):
    """point_jacobian_derivatives, cmm_derivative, cmm_derivative_fast and
    cmm_v_derivative of the port, batched over two configurations, against
    the reference's at 1e-10; and _terms_and_dq_ad (full and SRBD) against
    the reference's, on the synthetic biped."""
    model, info, tm, ti, _, _, _ = tiny
    rng = np.random.default_rng(9)
    qs = np.stack([_rand_q(model, rng) for _ in range(2)])
    v = rng.normal(size=(2, model.nv))
    anc = model.ancestor_mask()[[model.frame_body[f] for f in info.contact_frame_ids]]
    move = np.zeros((len(info.contact_frame_ids), model.nv), dtype=bool)
    move[:, :6] = True
    move[:, 6:] = anc

    def j_all(q, vv):
        kin = jk.forward_kinematics(model, q)
        fields = jso.velocity_fields(model, kin)
        ps = jnp.stack([jk.frame_position(model, kin, f) for f in info.contact_frame_ids])
        J = jk.stacked_point_jacobians(model, kin, ps, anc)
        dJv, dJw = jso.point_jacobian_derivatives(model, fields, ps, J[:, :3, :], move)
        return (dJv, dJw, jso.cmm_derivative(model, kin, fields), jso.cmm_derivative_fast(model, kin, fields),
                jso.cmm_v_derivative(model, kin, fields, vv), jso._skew_batch(fields.w))

    want = jax.jit(jax.vmap(j_all))(jnp.asarray(qs), jnp.asarray(v))
    q_t, v_t = T(qs), T(v)
    kin = tk.forward_kinematics(tm, q_t)
    fields = tso.velocity_fields(tm, kin)
    ps = torch.stack([tk.frame_position(tm, kin, f) for f in ti.contact_frame_ids], dim=-2)
    J = tk.stacked_point_jacobians(tm, kin, ps, anc)
    dJv, dJw = tso.point_jacobian_derivatives(tm, fields, ps, J[..., :3, :], move)
    got = (dJv, dJw, tso.cmm_derivative(tm, kin, fields), tso.cmm_derivative_fast(tm, kin, fields),
           tso.cmm_v_derivative(tm, kin, fields, v_t), tso._skew_batch(fields.w))
    for name, g, w in zip(("dJv", "dJw", "cmm_derivative", "cmm_derivative_fast", "cmm_v_derivative", "skew"),
                          got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _check(name, g, w, 1e-10)
    for i in (info, dataclasses.replace(info, model_type=0, q_j_nominal=())):
        ti_i = convert.info_from_numpy(dataclasses.asdict(i))
        w_terms, w_d = jax.jit(jax.vmap(lambda q: jl._terms_and_dq_ad(model, i, q)))(jnp.asarray(qs))
        g_terms, g_d = tl._terms_and_dq_ad(tm, ti_i, q_t)
        for f in w_terms._fields:
            _check(f, getattr(g_terms, f), getattr(w_terms, f), 1e-10)
            _check(f"d{f}", getattr(g_d, f), getattr(w_d, f), 1e-10)
        # the analytic terms and their q-Jacobians against the autodiff ones
        terms, dterms, *_ = tl._terms_and_dq(tm, ti_i, q_t)
        for f in terms._fields:
            _check(f"analytic {f}", getattr(terms, f), getattr(g_terms, f), 1e-12)
        _check("analytic dp_ee", dterms.p_ee, g_d.p_ee, 1e-10)
        _check("analytic dcom", dterms.com, g_d.com, 1e-10)
