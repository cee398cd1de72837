"""Component timing of every row of ``bench_controllers`` (counterpart of
``scripts/profile_generic.py``).

    python -m mmmpc_tpu_torch.profile_generic [batch] [name ...]
        [--device cpu] [--reps 20] [--solves 5]

For each row (demo_1d, base_only, arm_only, wholebody_endpoint,
wholebody_qref, wholebody_moving_obs; or the names given) at ``batch``
(default 8192; 8 with ``--device cpu``) and the row's own schedule, the
components of ``profile_solver``: the rollout, the fused backward (D; B on
the whole-body rows), the unfused expansion and E, the line search (C; A),
the step's argmin and merge, al_total and the multiplier update, each with
device, host and busy ms and its operators; then the predicted solve beside
the measured median of the row's solve (``batch_solve_fn``).  Returns
{row: record}.
"""

from __future__ import annotations

import sys

import torch

from mmmpc_tpu_torch.profile_solver import _parse, report


def main(argv=None):
    from mmmpc_tpu_torch.bench import BATCH
    from mmmpc_tpu_torch.bench_controllers import problems
    args = _parse(sys.argv[1:] if argv is None else argv, with_names=True)
    names = set(args.names)
    out = {}
    for name, mpc, x0_b, U0_b, params in problems(
            args.batch or BATCH, torch.device(args.device)):
        if names and name not in names:
            continue
        out[name] = report(name, mpc, x0_b, U0_b, params, mpc.solver_config,
                           args.reps, args.solves)
    return out


if __name__ == "__main__":
    main()
