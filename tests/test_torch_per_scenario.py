"""Per-robot targets for the generic controllers: each robot its own X_ref,
U_ref, Q, P and (the arm's and the endpoint's) U_last, as the JAX package's
vmapped solve takes them, against the JAX package.

- Kernel C's per-scenario instance (K5) by its plain version: the line
  search of every generic formulation (demo, base, the arm with its
  joint-space and its Cartesian reference, whole-body endpoint) on the
  problems of tests/torch_problems.py with ``generic_fleet_params`` (every
  reference row moved, full Q and P a robot, U_last a robot where the
  controller has one; float32, B=64, N=5), against
  JAX's ``core.fwd_pass`` vmapped over the step size and the robot with
  those entries mapped, the five formulations in one program compiled at
  XLA's lowest CPU optimisation level: X / U atol 2e-5, cost rtol = atol
  = 2e-3 (tests/test_generic_fwd.py).
- The line search's buffers: the shared entries packed once, each
  per-robot entry an operand of its own, batch-last, passed through
  without a copy where it is contiguous, so that they unpack back to each
  robot's params exactly, for every formulation and every mix of per-robot
  and shared entries (``torch_problems.PS_MIXES``).
- Each formulation's per-scenario solve takes the expansion route (D
  never runs: it reads no per-robot entry) and equals its robots solved
  one by one with their entries shared, float64, B=4: relative cost and
  violation within 1e-9; K5's plain version and E once an iteration.
- The base's per-scenario solve against JAX's ``al_ilqr_solve_batched``
  (its vmap of ``al_ilqr_solve`` on the CPU) on the same params, float64,
  B=16, compiled in a thread while the port solves: the gate of
  tests/test_torch_formulations.py (cost and violation within 5e-3
  absolute or relative on 99.5% of the robots, at most 0.5% converged-flag
  flips).
- An entry a generic controller does not take per robot (an eq_mask, which
  none of them has) raises with a batch axis.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmmpc_tpu import controllers as ctl_j
from mmmpc_tpu.models import obstacles as obs_j
from mmmpc_tpu.models import robots as robots_j
from mmmpc_tpu.solver import al_ilqr_solve_batched as solve_j
from mmmpc_tpu.solver.al_ilqr import build_core
from mmmpc_tpu.utils.configs import SolverConfig as SolverConfigJ
from mmmpc_tpu_torch.ops import generic_bwd, generic_fwd, riccati
from mmmpc_tpu_torch.solver.al_ilqr import iteration_count, rollout
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils import debugging
from mmmpc_tpu_torch.utils.convert import params_from_numpy

import torch_problems as tp
from torch_problems import B, FORMULATIONS, GENERIC_KEYS, N, PS_MIXES

F32 = jnp.float32
JAX_MODULES = (ctl_j, obs_j, robots_j)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
SOLVE_BATCH = 16
DIMS = {"demo": (2, 1), "base": (6, 2), "arm": (3, 3), "arm_cart": (3, 3),
        "endpoint": (9, 5)}

torch.set_num_threads(1)    # small batches: threads only contend


def _bm(a, *perm):
    """Batch-major numpy -> batch-last float32 tensor."""
    return torch.as_tensor(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), perm)))


def _fwd_inputs(name):
    """Formulation ``name``'s problem with per-robot entries and its line
    search's inputs, batch-major float32 numpy: (port controller, params,
    {X (B, N+1, nx) rollout, U, kff, K, lam, lam_t, lam_e})."""
    mpc, x0_b, U0_b, params = tp.generic_problem(name)
    params = tp.generic_fleet_params(params, B)
    p = params_from_numpy(params, "cpu", torch.float32)
    X, U = rollout(mpc.ocp, torch.as_tensor(x0_b, dtype=torch.float32).T,
                   torch.as_tensor(U0_b, dtype=torch.float32).permute(1, 2, 0),
                   p)
    fwd = mpc.ocp.lanes_fwd_factory(mpc.solver_config, p)
    rng = np.random.default_rng(11)
    nx, nu, f = mpc.NX, mpc.NU, fwd.form
    f32 = np.float32
    return mpc, params, dict(
        X=X.permute(2, 0, 1).numpy(), U=U.permute(2, 0, 1).numpy(),
        kff=(0.05 * rng.standard_normal((B, N, nu))).astype(f32),
        K=(0.05 * rng.standard_normal((B, N, nu, nx))).astype(f32),
        lam=np.abs(rng.standard_normal((B, N, f.nc))).astype(f32),
        lam_t=np.abs(rng.standard_normal((B, f.nct))).astype(f32),
        lam_e=np.zeros((B, 0), f32))


def _jax_fwd_program(args):
    """JAX's candidates of every formulation's line search, each robot with
    its own entries (in_axes 0 on the batch-first GENERIC_KEYS, the others
    shared), the five formulations in one program, compiled once."""
    mpcs = {name: tp.generic_controller(
        name, SolverConfigJ(**tp.GENERIC_CFG), JAX_MODULES)
        for name in FORMULATIONS}
    mu = jnp.asarray(10.0, F32)

    def row(name, shared, ps, X, U, kff, K, lam, lam_t, lam_e):
        cfg = mpcs[name].solver_config
        alphas = cfg.alpha_decay ** jnp.arange(cfg.n_alpha, dtype=F32)

        def one(q, X, U, kff, K, lam, lam_t, lam_e):
            core = build_core(mpcs[name].ocp, dict(shared, **q), cfg, F32)
            return jax.vmap(lambda a: core.fwd_pass(
                X[0], X, U, kff, K, a, (lam, lam_t, lam_e), mu))(alphas)
        return jax.vmap(one)(ps, X, U, kff, K, lam, lam_t, lam_e)

    def program(all_args):
        return {name: row(name, *a) for name, a in all_args.items()}

    return jax.jit(program).lower(args).compile(FAST_COMPILE)(args)


def _jax_solve(mpc_j, x0_b, U0_b, params):
    """JAX's batched solve (its per-scenario vmap on the CPU), float64."""
    args = (jnp.asarray(x0_b), jnp.asarray(U0_b),
            {k: jnp.asarray(v) for k, v in params.items()})
    return jax.jit(lambda x0, U0, p: solve_j(
        mpc_j.ocp, x0, U0, p, mpc_j.solver_config)).lower(*args).compile(
        FAST_COMPILE)(*args)


@pytest.fixture(scope="module")
def cases():
    """The port's line-search cases and its base solve, and JAX's results
    on the same inputs, JAX's two programs compiled and run in a thread
    while the port's side runs."""
    fwd_cases, jax_args = {}, {}
    for name in FORMULATIONS:
        mpc, params, a = _fwd_inputs(name)
        fwd_cases[name] = (mpc, params, a)
        shared = {k: jnp.asarray(v, F32) for k, v in params.items()
                  if k not in GENERIC_KEYS}
        ps = {k: jnp.asarray(np.moveaxis(params[k], -1, 0), F32)
              for k in tp.generic_keys(params)}
        jax_args[name] = (shared, ps, *(jnp.asarray(a[k], F32) for k in (
            "X", "U", "kff", "K", "lam", "lam_t", "lam_e")))
    mpc_t, x0_b, U0_b, base = tp.generic_problem("base", SOLVE_BATCH)
    solve_params = tp.generic_fleet_params(base, SOLVE_BATCH)
    mpc_j = tp.generic_controller("base", SolverConfigJ(**tp.GENERIC_CFG),
                                  JAX_MODULES)
    with ThreadPoolExecutor(2) as pool:
        jax_fwd = pool.submit(_jax_fwd_program, jax_args)
        jax_solve = pool.submit(_jax_solve, mpc_j, x0_b, U0_b, solve_params)
        res_t = al_ilqr_solve_batched(
            mpc_t.ocp, torch.as_tensor(x0_b), torch.as_tensor(U0_b),
            params_from_numpy(solve_params, "cpu", torch.float64),
            mpc_t.solver_config)
        refs = jax_fwd.result()
        res_j = jax_solve.result()
    return dict(fwd={k: (*v, refs[k]) for k, v in fwd_cases.items()},
                solve=(res_t, res_j))


@pytest.mark.parametrize("name", FORMULATIONS)
def test_per_scenario_fwd_plain_matches_jax(cases, name):
    mpc, params, a, (Xr, Ur, cr) = cases["fwd"][name]
    fwd = mpc.ocp.lanes_fwd_factory(
        mpc.solver_config, params_from_numpy(params, "cpu", torch.float32))
    assert fwd.ps_keys == tp.generic_keys(params)
    before = generic_fwd.LAUNCHES_PS[name].plain
    Xc, Uc, xlast, cost = fwd(
        _bm(a["X"][:, :-1], 1, 2, 0), _bm(a["U"], 1, 2, 0),
        _bm(a["kff"], 1, 2, 0), _bm(a["K"], 1, 2, 3, 0),
        _bm(a["lam"], 1, 2, 0), _bm(a["lam_t"], 1, 0),
        _bm(a["lam_e"], 1, 0), 10.0)
    assert generic_fwd.LAUNCHES_PS[name].plain == before + 1
    # JAX: (B, n_alpha, ...) -> the port's (..., n_alpha, ..., B)
    np.testing.assert_allclose(Xc.permute(3, 1, 0, 2).numpy(),
                               np.asarray(Xr[:, :, :-1]), atol=2e-5)
    np.testing.assert_allclose(xlast.permute(2, 0, 1).numpy(),
                               np.asarray(Xr[:, :, -1]), atol=2e-5)
    np.testing.assert_allclose(Uc.permute(3, 1, 0, 2).numpy(),
                               np.asarray(Ur), atol=2e-5)
    np.testing.assert_allclose(cost.T.numpy(), np.asarray(cr), rtol=2e-3,
                               atol=2e-3)


def _robot_params(fwd, b):
    """What kernel C's per-scenario instance reads for robot ``b``: the
    packed shared buffer, each per-robot entry from its operand."""
    return dict(fwd.form.unpack(fwd.flat),
                **{k: v[..., b] for k, v in fwd.operands.items()})


@pytest.mark.parametrize("name", ["demo", "endpoint"])
def test_line_search_packs_one_column_a_robot(name):
    """The per-scenario line search packs the shared entries once, at the
    shared instance's layout, a per-robot entry's slot zero-filled, and
    takes each per-robot entry as an operand (shape + (B,)): a robot's
    params are the shared buffer with its own column of each operand."""
    mpc, _, _, params = tp.generic_problem(name)
    ps = tp.generic_fleet_params(params, 3)
    fwd = mpc.ocp.lanes_fwd_factory(
        mpc.solver_config, params_from_numpy(ps, "cpu", torch.float64))
    size = fwd.form.pack(params_from_numpy(params, "cpu",
                                           torch.float64)).numel()
    assert tuple(fwd.flat.shape) == (size,)
    assert tuple(fwd.operands) == tp.generic_keys(params)
    shared = fwd.form.unpack(fwd.flat)
    for k, v in fwd.operands.items():
        assert tuple(v.shape) == tuple(fwd.form.shapes[k]) + (3,)
        assert not shared[k].any(), k
    for b in range(3):
        one = {k: (v[..., b] if k in GENERIC_KEYS else v)
               for k, v in ps.items()}
        want = fwd.form.unpack(fwd.form.pack(
            params_from_numpy(one, "cpu", torch.float64)))
        got = _robot_params(fwd, b)
        for k in fwd.form.shapes:
            assert torch.equal(got[k], want[k]), (b, k)


@pytest.mark.parametrize("name", FORMULATIONS)
def test_line_search_buffers_unpack_to_each_robot(name):
    """For each mix of per-robot and shared entries (all of them, and each
    of ``PS_MIXES`` the formulation has), the wrapper's buffers unpack back
    to each robot's params exactly; a contiguous batch-last entry is the
    operand itself (same ``data_ptr``, no copy), and only the per-robot
    entries are operands."""
    mpc, _, _, params = tp.generic_problem(name)
    mixes = [GENERIC_KEYS, *(k for k in PS_MIXES.values()
                             if set(k) <= set(params))]
    for keys in mixes:
        ps = params_from_numpy(tp.generic_mix_params(params, 5, keys), "cpu",
                               torch.float32)
        fwd = mpc.ocp.lanes_fwd_factory(mpc.solver_config, ps)
        assert set(fwd.operands) == set(keys) & set(params), keys
        for k, v in fwd.operands.items():
            assert v.data_ptr() == ps[k].data_ptr(), (keys, k)
        for b in range(5):
            got = _robot_params(fwd, b)
            for k in fwd.form.shapes:
                want = ps[k][..., b] if k in fwd.operands else ps[k]
                assert torch.equal(got[k], want), (keys, b, k)


@pytest.mark.parametrize("name", FORMULATIONS)
def test_per_scenario_solve_equals_separate_solves(name):
    """The generic per-scenario solve at B=4 (float64, plain kernels) takes
    the expansion route and equals its robots solved one by one."""
    mpc, x0_b, U0_b, params = tp.generic_problem(name, 4)
    p = params_from_numpy(tp.generic_fleet_params(params, 4), "cpu",
                          torch.float64)
    x0, U0 = torch.as_tensor(x0_b), torch.as_tensor(U0_b)
    counters = (generic_fwd.LAUNCHES_PS[name], generic_bwd.LAUNCHES[name],
                riccati.LAUNCHES[DIMS[name]])
    for c in counters:
        c.reset()
    res = al_ilqr_solve_batched(mpc.ocp, x0, U0, p, mpc.solver_config)
    n = iteration_count(mpc.solver_config)
    assert [c.plain for c in counters] == [n, 0, n]
    for b in range(4):
        one = al_ilqr_solve_batched(mpc.ocp, x0[b:b + 1], U0[b:b + 1],
                                    debugging.scenario_params(p, b),
                                    mpc.solver_config)
        rel = abs(float(res.cost[b] - one.cost[0])) / abs(float(one.cost[0]))
        assert rel <= 1e-9, (b, rel)
        assert abs(float(res.max_violation[b] - one.max_violation[0])) \
            <= 1e-9 * max(1.0, abs(float(one.max_violation[0])))


def test_per_scenario_base_solve_matches_jax(cases):
    res_t, res_j = cases["solve"]
    for field in ("cost", "max_violation"):
        a = getattr(res_t, field).numpy()
        b = np.asarray(getattr(res_j, field))
        tight = (np.abs(a - b) <= 5e-3) | (
            np.abs(a - b) <= 5e-3 * np.maximum(np.abs(b), 1e-3))
        assert tight.mean() >= 0.995, f"{field}: {(~tight).sum()} robots"
    flips = res_t.converged.numpy() != np.asarray(res_j.converged)
    assert flips.mean() <= 0.005, f"{flips.sum()} convergence flips"


def test_shared_only_entry_raises():
    """An eq_mask is not among the entries a generic controller takes per
    robot: with a batch axis the solve raises before any work."""
    mpc, x0_b, U0_b, params = tp.generic_problem("arm", 4)
    params = dict(params, eq_mask=np.ones(4))
    p = params_from_numpy(params, "cpu", torch.float64)
    with pytest.raises(ValueError, match="shared only"):
        al_ilqr_solve_batched(mpc.ocp, torch.as_tensor(x0_b),
                              torch.as_tensor(U0_b), p,
                              mpc.solver_config)
