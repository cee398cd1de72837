"""The port's assoc-route solve against the JAX package's on the long-horizon
benchmark's problem, and the two routes of each package side by side.

``bench_longhorizon``'s problem (scenario 1, the JAX script's schedule: 2 AL
rounds of 4 then 3 sweeps, 4 step sizes, cost_scale 1e5) at N = 100 and
batch 8 from rest, one AL round of its 4 sweeps (the schedule's second
round would double the JAX program's trace), in float64 on both sides,
the params the float64 ones of ``bench_longhorizon.build_numpy`` (the JAX
script's before its cast to float32): the port's solve with
``use_assoc_scan=True`` (the AL expansion, ``ops/assoc_riccati.py``, A's
plain version) against JAX's
``al_ilqr_solve_batched`` with ``use_assoc_scan=True`` (its vmapped route,
``core.stage_derivs`` and ``lax.associative_scan``): every robot's cost
within 5e-3, relative, and the same converged flags.  JAX's program is
compiled at XLA's lowest CPU optimisation level in a thread while the
port solves.

The two routes are not held to each other on this problem: both sweeps
regularise differently (the assoc sweep also in its input elimination,
whose input Hessian, 2e-6 at cost_scale 1e5, is of the order of the least
reg, 1e-6), and over 14 sweeps the iterates part by up to tens of percent
of the cost in JAX as in the port.  Run as a script, the file measures
that on the CPU:

    python -m tests.test_torch_assoc_solve [N,batch ...]

prints, for each shape (default 20,8 100,8 500,1 2000,1) and dtype, JAX's
scan route against its assoc route (relative mean cost, shared converged
flags, converged shares, the share of robots whose inputs left the
initial guess) and each of the port's CPU routes against JAX's same route
(the largest relative cost of a robot, converged flags apart), one JSON
object a line.
"""

import dataclasses
import importlib.util
import json
import sys
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmmpc_tpu.solver.batched import al_ilqr_solve_batched as solve_j
from mmmpc_tpu_torch import bench_longhorizon
from mmmpc_tpu_torch.ops import assoc_riccati
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils.convert import params_from_numpy

# XLA's lowest CPU optimisation level: the same operations, less compile
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)    # small batches: threads only contend


def _jax_script():
    """``scripts/bench_longhorizon.py`` of the JAX package, as a module."""
    spec = importlib.util.spec_from_file_location(
        "bench_longhorizon_j", ROOT / "scripts" / "bench_longhorizon.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    return script


def problem(N, batch):
    """(JAX controller, JAX config, port controller, x0_b (batch, 9) and
    params as float64 numpy): the JAX script's problem at its own
    controller, the data the port's float64 build."""
    script = _jax_script()
    mpc_j = script.build(N, 1)[0]
    mpc_t, x0_b, params = bench_longhorizon.build_numpy(N, batch)
    params = {k: np.asarray(v, np.float64) for k, v in params.items()}
    return mpc_j, script.CFG, mpc_t, x0_b, params


def jax_solve(mpc_j, cfg_j, x0_b, params, assoc, dtype, **schedule):
    """JAX's batched solve from rest by the route ``assoc`` (the script's
    schedule but for ``schedule``), compiled at ``FAST_COMPILE``."""
    cfg = dataclasses.replace(cfg_j, use_assoc_scan=assoc, **schedule)
    N = mpc_j.N
    args = (jnp.asarray(x0_b, dtype), jnp.zeros((len(x0_b), N, 5), dtype),
            {k: jnp.asarray(v, dtype) for k, v in params.items()})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        fn = jax.jit(lambda x0, U0, p: solve_j(mpc_j.ocp, x0, U0, p, cfg))
        out = fn.lower(*args).compile(FAST_COMPILE)(*args)
    return {k: np.asarray(getattr(out, k)) for k in
            ("cost", "converged", "max_violation", "U")}


def port_solve(mpc_t, x0_b, params, assoc, dtype, **schedule):
    """The port's batched solve from rest by the route ``assoc`` on the CPU
    (the kernels' plain versions; the benchmark's schedule but for
    ``schedule``), with the assoc sweep's calls."""
    cfg = dataclasses.replace(bench_longhorizon.CFG, use_assoc_scan=assoc,
                              **schedule)
    N = mpc_t.N
    assoc_riccati.CALLS.reset()
    with warnings.catch_warnings(), torch.inference_mode():
        warnings.simplefilter("ignore", UserWarning)
        out = al_ilqr_solve_batched(
            mpc_t.ocp, torch.as_tensor(x0_b, dtype=dtype),
            torch.zeros(len(x0_b), N, 5, dtype=dtype),
            params_from_numpy(params, "cpu", dtype), cfg)
    res = {k: getattr(out, k).double().numpy() if k != "converged" else
           getattr(out, k).numpy() for k in
           ("cost", "converged", "max_violation", "U")}
    res["assoc_calls"] = assoc_riccati.CALLS.plain
    return res


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


def test_assoc_solve_matches_jax():
    mpc_j, cfg_j, mpc_t, x0_b, params = problem(100, 8)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(jax_solve, mpc_j, cfg_j, x0_b, params, True,
                          jnp.float64, al_iters=1)
        got = port_solve(mpc_t, x0_b, params, True, torch.float64,
                         al_iters=1)
        ref = fut.result()
    # the route: the assoc sweep once an iteration
    assert got["assoc_calls"] == bench_longhorizon.CFG.ilqr_iters
    rel = _rel(got["cost"], ref["cost"])
    assert rel.max() <= 5e-3, rel
    np.testing.assert_array_equal(got["converged"], ref["converged"])
    # robots of both kinds, so the flags are a check
    assert 0 < ref["converged"].sum() < len(x0_b), ref["converged"]


def witness(N, batch):
    """The rows of the script: for float32 and float64, JAX's two routes
    against each other and the port's CPU routes against JAX's same
    route."""
    mpc_j, cfg_j, mpc_t, x0_b, params = problem(N, batch)
    rows = []
    for name, dj, dt in (("float32", jnp.float32, torch.float32),
                         ("float64", jnp.float64, torch.float64)):
        j = {a: jax_solve(mpc_j, cfg_j, x0_b, params, a, dj)
             for a in (False, True)}
        t = {a: port_solve(mpc_t, x0_b, params, a, dt) for a in (False, True)}
        row = {"N": N, "batch": batch, "dtype": name}
        for a, r in (("scan", False), ("assoc", True)):
            row[f"jax_{a}_converged"] = float(j[r]["converged"].mean())
            row[f"jax_{a}_moved"] = float(
                (j[r]["U"] != 0).reshape(batch, -1).any(1).mean())
            row[f"port_{a}_vs_jax_max_rel_cost"] = float(
                _rel(t[r]["cost"], j[r]["cost"].astype(np.float64)).max())
            row[f"port_{a}_vs_jax_flags_apart"] = int(
                (t[r]["converged"] != j[r]["converged"]).sum())
        cs, ca = (j[a]["cost"].astype(np.float64).mean() for a in (False,
                                                                   True))
        row["jax_rel_mean_cost"] = float(abs(ca - cs) / abs(cs))
        row["jax_same_converged"] = float(
            (j[False]["converged"] == j[True]["converged"]).mean())
        cs, ca = (t[a]["cost"].mean() for a in (False, True))
        row["port_rel_mean_cost"] = float(abs(ca - cs) / abs(cs))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    shapes = [tuple(int(v) for v in s.split(",")) for s in
              (sys.argv[1:] or ["20,8", "100,8", "500,1", "2000,1"])]
    for n, b in shapes:
        witness(n, b)
