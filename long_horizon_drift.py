"""How far kernels A, B and E drift from float64 over long horizons, on the
card, at the inputs ``chip_smoke.py``'s long-horizon checks could take.

On ``bench_longhorizon``'s problem at batch 64 and N = 500 and 2000, with
``chip_smoke.py``'s seeded kernel inputs (phase 3's), this script calls
each kernel and its plain version in float32 and in float64 on the same
inputs:

- B and E at reg 1e-6 (the solve's least reg), 1e-4 and 1e-2;
- A with no feedback (K = 0) and with B's gains at reg 1e-4 (its
  feedforward the seeded random one).

For each output it prints the entries outside the bench tolerances of
the float32 plain version, the largest error of the kernel and of the
float32 plain version against float64, and ``tests/torch_problems.py::
drift_gate``'s ratio at a window of 0 stages (each stage against the plain
version's error on that stage alone) and of 32 (the gate's): at most 1
holds.  Needs a CUDA card:

    python3 long_horizon_drift.py [N ...]
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as cs  # noqa: E402
from mmmpc_tpu_torch import bench_longhorizon  # noqa: E402
from mmmpc_tpu_torch.ops.riccati import (  # noqa: E402
    plain_riccati_bm, riccati_backward_bm,
)
from mmmpc_tpu_torch.solver.al_ilqr import (  # noqa: E402
    stage_al_blocks, terminal_al_blocks,
)
from torch_problems import drift_gate  # noqa: E402

BATCH = 64


def report(tag, got, ref, truth, tols):
    """One line an output: the numbers of the module's docstring."""
    for i, (g, r, t, (rtol, atol)) in enumerate(zip(got, ref, truth, tols)):
        g, r = g.double(), r.double()
        off = int(((g - r).abs() > atol + rtol * r.abs()).sum())
        per_stage = drift_gate(g, r, t, rtol, atol, window=0)
        windowed = drift_gate(g, r, t, rtol, atol)
        print(f"[drift] {tag} output={i} finite={bool(torch.isfinite(g).all())}"
              f" outside_plain_tol={off} kernel_err_f64="
              f"{(g - t).abs().max():.3e} plain_f32_err_f64="
              f"{(r - t).abs().max():.3e} largest_truth={t.abs().max():.3e} "
              f"ratio_stage={per_stage[0]:.3f}@{per_stage[1]} "
              f"ratio_window32={windowed[0]:.3f}@{windowed[1]}", flush=True)


def main(horizons):
    device = torch.device("cuda", 0)
    for N in horizons:
        mpc, x0, _, params = bench_longhorizon.build(N, BATCH, device)
        cfg = mpc.solver_config
        fargs, bargs = cs._wholebody_args(
            mpc, x0, params, np.random.default_rng(cs.SEED), device)
        fwd = mpc.ocp.lanes_fwd_factory(cfg, params)
        bwd = mpc.ocp.lanes_bwd_factory(cfg, params)
        X, U, lam, lamt, lame, mu, reg = bargs
        inv = 1.0 / cfg.cost_scale
        blocks = (*stage_al_blocks(mpc.ocp, params, inv, X[:-1], U, lam, mu),
                  *terminal_al_blocks(mpc.ocp, params, inv, X[-1], lamt, lame,
                                      mu))
        for r in (1e-6, 1e-4, 1e-2):
            a = (*bargs[:-1], torch.full_like(reg, r))
            report(f"wholebody_bwd N={N} reg={r:g}", bwd.cuda(*a),
                   bwd.plain(*a), cs._plain_f64(bwd, a), cs.BWD_TOLS)
            e = (*blocks, torch.full_like(reg, r))
            report(f"riccati_bwd.9x5 N={N} reg={r:g}", riccati_backward_bm(*e),
                   plain_riccati_bm(*e),
                   plain_riccati_bm(*(t.double() for t in e)), cs.BWD_TOLS)
        gains = bwd.cuda(*bargs[:-1], torch.full_like(reg, 1e-4))[1]
        for name, K in (("K=0", torch.zeros_like(fargs[3])),
                        ("K=B's at reg 1e-4", gains)):
            a = (*fargs[:3], K, *fargs[4:])
            report(f"wholebody_fwd N={N} {name}", fwd.cuda(*a), fwd.plain(*a),
                   cs._plain_f64(fwd, a), cs.FWD_TOLS)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("long_horizon_drift: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.exit(main([int(n) for n in sys.argv[1:]] or [500, 2000]))
