"""The two loose rows of the fidelity dossier: distinct optima or an
unconverged solve? (counterpart of ``scripts/fidelity_analysis.py``)

    python -m mmmpc_tpu_torch.fidelity_analysis [--device cpu]
        [--n-starts 9]

1. arm only (``MPCManipulator3DoF``, N=10, ``TIGHT``): multi-start the
   L-BFGS-B oracle (zero inputs, ``n_starts - 2`` draws of
   ``default_rng(7)`` and our solution), then cross-polish: our solver
   warm-started from the oracle's best, the oracle from ours.  Where the
   oracle's best violates a state or rate bound that L-BFGS-B ignores (its
   lower cost is a relaxation's), the feasible trust-constr oracle decides
   the verdict.
2. qref at N=20, production against tight: tight-polish the production
   solution and compare with the tight solve from scratch.  A polish that
   reaches the tight cost while staying far from both solutions in U means
   a near-degenerate valley (dU is the wrong metric); one that walks to the
   tight solution means production is under-converged.

The solves are the port's batched solver at batch 1 (``al_ilqr_solve_batched``
through kernels C and D for the arm, A and B for qref) on the card in
float32, the kernels' dtype; the oracles and ``_stage_violation`` run on
the host in float64 (``verify/oracle.py``), the oracles in a pool of
worker processes with one BLAS thread each.  ``--device cpu`` runs
everything in float64 (the kernels' plain versions).  Prints one JSON
verdict a case.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from mmmpc_tpu_torch.controllers import MPCManipulator3DoF
from mmmpc_tpu_torch.fidelity_dossier import (
    DT, ONE_THREAD, PROD, TIGHT, XTREME, _environ, self_consistency_setup,
)
from mmmpc_tpu_torch.models.robots import ManipulatorPanda3DoF
from mmmpc_tpu_torch.solver.al_ilqr import SolveResult
from mmmpc_tpu_torch.solver.batched import al_ilqr_solve_batched
from mmmpc_tpu_torch.utils.convert import params_from_numpy
from mmmpc_tpu_torch.verify.oracle import (
    _plain_rollout, lbfgs_solve, scipy_solve,
)

N_STARTS = 9           # zero inputs, 7 draws, our solution
TRUST_MAXITER = 3000
F64 = torch.float64


def solve(mpc, x0, U0, params, cfg, device, dtype):
    """One batch-1 solve of the port's batched solver from ``U0`` (N, nu):
    the batch-free SolveResult, float64 on the CPU (``converged`` bool)."""
    kw = dict(dtype=dtype, device=device)
    with torch.inference_mode():
        res = al_ilqr_solve_batched(
            mpc.ocp, torch.as_tensor(np.asarray(x0), **kw)[None],
            torch.as_tensor(np.asarray(U0), **kw)[None],
            params_from_numpy(params, device, dtype), cfg)
    return SolveResult(*(f[0].cpu() if f.dtype == torch.bool
                         else f[0].to("cpu", F64) for f in res))


def _stage_violation(ocp, x0, U, params):
    """The worst stage and terminal inequality row of the inputs U (N, nu)
    rolled out from x0, in float64 on the CPU."""
    p = {k: torch.as_tensor(np.asarray(v), dtype=F64) for k, v in
         params.items()}
    U = torch.as_tensor(np.asarray(U), dtype=F64)
    X = _plain_rollout(ocp, torch.as_tensor(np.asarray(x0), dtype=F64), U)
    cs = ocp.stage_ineq(X[:-1], U, torch.arange(ocp.N), p)
    ct = ocp.terminal_ineq(X[-1], p)
    return float(torch.maximum(torch.max(cs), torch.max(ct)))


def _arm_problem(device):
    """The arm-only problem: (controller on ``device``, q0, params as host
    arrays)."""
    arm = MPCManipulator3DoF(ManipulatorPanda3DoF(DT), [], [], N=10,
                             solver_config=TIGHT, device=device)
    q0 = np.array([0.3, -1.2, 1.2])
    traj = np.linspace(q0, np.array([0.0, -0.6, 0.9]), 11)
    params = dict(arm.make_params(traj, np.zeros((10, 3))),
                  U_last=np.zeros((10, 3)))
    return arm, q0, params


def _oracle_task(U0, trust_maxiter=None):
    """An oracle's solve of the arm problem from ``U0`` on the CPU in
    float64 (a worker process): L-BFGS-B, or trust-constr with
    ``trust_maxiter``.  Returns (cost, U numpy)."""
    torch.set_num_threads(1)
    arm, q0, params = _arm_problem("cpu")
    if trust_maxiter is None:
        U, _, cost, _ = lbfgs_solve(arm.ocp, q0, U0, params)
    else:
        U, _, cost, _ = scipy_solve(arm.ocp, q0, U0, params,
                                    maxiter=trust_maxiter)
    return float(cost), U.numpy()


def arm_case(device="cuda", dtype=torch.float32, n_starts=N_STARTS):
    if n_starts < 2:
        raise ValueError("n_starts counts zero inputs and our solution: >= 2")
    arm, q0, params = _arm_problem(device)
    ocp = arm.ocp
    zeros = np.zeros((10, 3))
    # multi-start oracle: zero + perturbed warm starts + ours.  Each oracle
    # solve runs in a worker process with one BLAS thread (OpenBLAS's
    # thread a core made a trust-constr solve 14x slower), the workers
    # started while our solver runs; trust-constr from zero inputs too,
    # read only where L-BFGS-B's best is infeasible
    rng = np.random.default_rng(7)
    starts = [zeros] + [0.3 * rng.standard_normal((10, 3))
                        for _ in range(n_starts - 2)]
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, min(n_starts + 1, (os.cpu_count() or 2) - 1))
    with _environ(ONE_THREAD), ProcessPoolExecutor(
            workers, mp_context=ctx) as pool:
        futures = [pool.submit(_oracle_task, U0) for U0 in starts]
        trust = pool.submit(_oracle_task, zeros, TRUST_MAXITER)
        ours = solve(arm, q0, zeros, params, TIGHT, device, dtype)
        futures.append(pool.submit(_oracle_task, ours.U.numpy()))
        sols = [f.result() for f in futures]
        costs = np.array([c for c, _ in sols])
        best = int(costs.argmin())

        # cross-polish: our solver warm-started from the oracle's best
        ours_from_oracle = solve(arm, q0, sols[best][1], params, TIGHT,
                                 device, dtype)
        # the oracle's polish of OUR solution is sols[-1] (warm start ours.U)
        oracle_from_ours_cost, oracle_from_ours_U = sols[-1]

        dU_cross = float(np.max(np.abs(ours_from_oracle.U.numpy()
                                       - sols[best][1])))
        dU_oracle_stay = float(np.max(np.abs(oracle_from_ours_U
                                             - ours.U.numpy())))
        out = {
            "case": "arm_only",
            "our_cost": float(ours.cost),
            "our_viol": float(ours.max_violation),
            "oracle_costs_multistart": sorted(np.round(costs, 10).tolist()),
            "oracle_best_cost": float(costs[best]),
            "our_solver_from_oracle_best": {
                "cost": float(ours_from_oracle.cost),
                "max_dU_vs_oracle_best": dU_cross,
            },
            "oracle_from_our_solution": {
                "cost": oracle_from_ours_cost,
                "max_dU_vs_ours": dU_oracle_stay,
            },
        }
        # the feasibility of the oracle's "better" solution decides the
        # verdict: L-BFGS-B ignores the state and rate boxes, so a lower
        # cost with an infeasible iterate is a relaxation's bound, not a
        # solution
        oracle_viol = _stage_violation(ocp, q0, sols[best][1], params)
        out["oracle_best_violation"] = oracle_viol
        if oracle_viol > 1e-6:
            cost_t, U_t = trust.result()
            dU_t = float(np.max(np.abs(ours.U.numpy() - U_t)))
            out["trust_constr"] = {
                "cost": cost_t,
                "violation": _stage_violation(ocp, q0, U_t, params),
                "max_dU_vs_ours": dU_t,
            }
            out["verdict"] = (
                "oracle artifact: the L-BFGS-B relaxation's lower cost "
                "violates an ignored state/rate constraint by "
                f"{oracle_viol:.2e} (= the reported dU); vs the feasible "
                f"trust-constr oracle our solution matches to {dU_t:.1e}")
        else:
            out["verdict"] = ("single basin; solver-tolerance-level "
                              "differences")
    return out


def qref_case(device="cuda", dtype=torch.float32):
    mpc, x0, params = self_consistency_setup(device)
    zeros = np.zeros((20, 5))
    r_prod = solve(mpc, x0, zeros, params, PROD, device, dtype)
    r_tight = solve(mpc, x0, zeros, params, XTREME, device, dtype)
    # tight-polish the production iterate
    r_polish = solve(mpc, x0, r_prod.U, params, XTREME, device, dtype)

    def max_dU(a, b):
        return float(torch.max(torch.abs(a.U - b.U)))

    dU_prod_tight = max_dU(r_prod, r_tight)
    dU_polish_prod = max_dU(r_polish, r_prod)
    dU_polish_tight = max_dU(r_polish, r_tight)
    out = {
        "case": "qref_n20_self_consistency",
        "cost_prod": float(r_prod.cost),
        "cost_tight": float(r_tight.cost),
        "cost_polish_of_prod": float(r_polish.cost),
        "viol": [float(r_prod.max_violation), float(r_tight.max_violation),
                 float(r_polish.max_violation)],
        "dU_prod_vs_tight": dU_prod_tight,
        "dU_polish_vs_prod": dU_polish_prod,
        "dU_polish_vs_tight": dU_polish_tight,
        "rel_dcost_polish_vs_tight": float(
            (r_polish.cost - r_tight.cost) / abs(r_tight.cost)),
    }
    if out["rel_dcost_polish_vs_tight"] < 1e-3 and \
            min(dU_polish_prod, dU_polish_tight) > 0.1:
        out["verdict"] = (
            "near-degenerate valley: the tight polish of the production "
            "iterate reaches the tight-from-scratch cost (rel "
            f"{out['rel_dcost_polish_vs_tight']:+.1e}) while remaining "
            f"max|dU| {dU_polish_prod:.2f} from the production iterate AND "
            f"{dU_polish_tight:.2f} from the tight-from-scratch solution — "
            "the redundantly-actuated problem has multiple near-equal-cost "
            "feasible minima far apart in U; rel dcost at feasibility is "
            "the acceptance metric, dU is not")
    elif dU_polish_tight < 0.1 * dU_prod_tight:
        out["verdict"] = "production solve under-converged"
    else:
        out["verdict"] = "inconclusive"
    return out


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n-starts", type=int, default=N_STARTS)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(sys.argv[1:] if argv is None else argv)
    # float32 on the card (the kernels' dtype), float64 on the CPU
    dtype = torch.float32 if args.device == "cuda" else F64
    torch.set_num_threads(1)     # batch 1 and scipy: threads only contend
    outs = []
    for case in (lambda: arm_case(args.device, dtype, args.n_starts),
                 lambda: qref_case(args.device, dtype)):
        outs.append(case())
        print(json.dumps(outs[-1], indent=1), flush=True)
    return outs


if __name__ == "__main__":
    main()
