"""The two kernels on the team Riccati step at each team size, on the card.

Kernel E, ``mmmpc_tpu_torch/csrc/riccati.cu``, takes its lanes a scenario
from one rule, ``ric_team(nx, nu)``; kernel D.endpoint,
``csrc/generic_endpoint.cu``, from ``Endpoint::BWD_TEAM``.  From those
sources this script builds, for each team size T of ``TEAMS``, a library of
E's four pairs (the rule replaced by ``return T;``) and a library of the
endpoint formulation (``BWD_TEAM = T``), one ``nvcc`` a library, all
started together, into ``build/torch_kernels/teams/``, prints each build's
ptxas registers and spills, and for each T:

- E at each pair against its plain version on the Pallas test's random SPD
  blocks (N=4, B=1024) at rtol = atol = 2e-4 (its ``[kernel]`` line), and
  its device time per launch at N=20, B=8192 on random SPD blocks of that
  horizon (CUDA-graph replay of 20 launches, as ``chip_smoke.py``'s
  ``[kernel]``), with the launch geometry and the blocks an SM holds
  (``[team]``);
- D.endpoint on the inputs of ``chip_smoke.py``'s ``[kernel]`` check of
  the endpoint row at batch 8192, against its plain version at its
  tolerance (atol 2e-4, rtol 1e-4), and its device time per launch, with
  the launch geometry (``[team]``).

Needs a CUDA card and ``nvcc``:

    python3 team_sweep.py [T ...]

Exits nonzero if a build or a check fails.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from mmmpc_tpu_torch.ops import _cuda  # noqa: E402

OUT = _cuda.BUILD_DIR / "teams"
TEAMS = (1, 2, 4, 8, 16)
# each kernel: (its source, the team rule in it, prefix of its C entries)
RULES = {
    "riccati": ("riccati.cu", "  int t = 1;\n"
                "  while (4 * t < nx + nu && t < 8) t *= 2;\n"
                "  return t;\n", "ric_"),
    "endpoint": ("generic_endpoint.cu",
                 "  static constexpr int BWD_TEAM = 8;\n", "gen_"),
}


def _variant(kernel, team):
    return (f"  return {team};\n" if kernel == "riccati"
            else f"  static constexpr int BWD_TEAM = {team};\n")


def build(teams):
    """One library of each kernel a team size; returns (kernel, T) -> path."""
    procs = {}
    for kernel, (src_name, rule, _) in RULES.items():
        for team in teams:
            src_dir = OUT / f"{kernel}_T{team}"
            if src_dir.exists():
                shutil.rmtree(src_dir)
            shutil.copytree(_cuda.CSRC, src_dir)
            src = (src_dir / src_name).read_text()
            if rule not in src:
                raise ValueError(f"{src_name}: the team rule is not as "
                                 f"expected")
            (src_dir / src_name).write_text(
                src.replace(rule, _variant(kernel, team)))
            procs[kernel, team] = subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                 str(OUT / f"lib{kernel}_T{team}.so"), str(src_dir / src_name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (kernel, team), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel}, T = {team}:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"[ptxas] kernel={kernel} team={team} {ln.strip()}",
                      flush=True)
    return {v: OUT / f"lib{v[0]}_T{v[1]}.so" for v in procs}


def load(kernel, path):
    """The library at ``path`` with the signatures of ``kernel``'s C
    entries that it holds."""
    lib = ctypes.CDLL(str(path))
    prefix = RULES[kernel][2]
    for name, argtypes in _cuda.SIGNATURES.items():
        if name.startswith(prefix) and (kernel == "riccati"
                                        or name.endswith("_endpoint")):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def endpoint_args(device):
    """The endpoint row's fused backward and its arguments at batch 8192,
    made as ``chip_smoke.check_generic`` makes them."""
    import numpy as np

    import chip_smoke
    from mmmpc_tpu_torch.bench_controllers import problems
    from mmmpc_tpu_torch.solver.al_ilqr import rollout

    for row, mpc, x0, _, params in problems(chip_smoke.BATCH, device):
        if row != "wholebody_endpoint":
            continue
        rng = np.random.default_rng(chip_smoke.SEED)
        N, B, nx, nu = mpc.N, chip_smoke.BATCH, mpc.NX, mpc.NU
        bwd = mpc.ocp.lanes_bwd_factory(mpc.solver_config, params)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        X, U = rollout(mpc.ocp, x0.T,
                       t(0.3 * rng.standard_normal((N, nu, B))), params)
        # the draws of chip_smoke's forward arguments, then the backward's
        for shape in ((N, nu, B), (N, nu, nx, B)):
            rng.standard_normal(shape)
        rng.standard_normal((N, bwd.form.nc, B))
        rng.standard_normal((bwd.form.nct, B))
        return bwd, (X, U, t(0.3 * np.abs(rng.standard_normal(
            (N, bwd.form.nc, B)))), t(0.3 * np.abs(rng.standard_normal(
                (bwd.form.nct, B)))), t(np.zeros((0, B))), 10.0,
            torch.full((B,), 1e-6, device=device))
    raise ValueError("no wholebody_endpoint row")


def main(argv):
    if not torch.cuda.is_available():
        print("team_sweep: no CUDA card", file=sys.stderr)
        return 1
    teams = [int(a) for a in argv] or list(TEAMS)
    import chip_smoke
    from mmmpc_tpu_torch.ops import generic_bwd
    from mmmpc_tpu_torch.ops.riccati import (
        launch_geometry, riccati_backward_bm,
    )

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[device] nvidia_smi={smi!r}", flush=True)
    device = torch.device("cuda", 0)
    OUT.mkdir(parents=True, exist_ok=True)
    libs = build(teams)
    bwd, bargs = endpoint_args(device)
    for team in teams:
        _cuda.LIBRARY.lib = load("endpoint", libs["endpoint", team])
        got, ref = bwd.cuda(*bargs), bwd.plain(*bargs)
        torch.cuda.synchronize()
        err = chip_smoke._gains_check(f"generic_bwd.endpoint T={team}", 1e-4,
                                      2e-4)(got, ref, bargs)
        ms = chip_smoke._kernel_ms(lambda: bwd.cuda(*bargs), 20)
        print(f"[team] name=generic_bwd.endpoint N={bwd.ocp.N} "
              f"B={chip_smoke.BATCH} max_abs_err={err:.4g} ms={ms:.5g} "
              + " ".join(f"{k}={v}" for k, v in generic_bwd.launch_geometry(
                  _cuda.LIBRARY.lib, "endpoint", bwd.ocp.N, bwd.form.n_obs,
                  bwd.form.n_hp, chip_smoke.BATCH).items()), flush=True)
    for team in teams:
        _cuda.LIBRARY.lib = load("riccati", libs["riccati", team])
        for nx, nu in _cuda.RICCATI_INSTANCES:
            chip_smoke.check_riccati(
                f"spd_team_{team}", chip_smoke.spd_blocks(device, nx=nx, nu=nu),
                torch.full((1024,), 1e-6, device=device),
                chip_smoke._gains_check(f"riccati_bwd.{nx}x{nu} T={team}",
                                        2e-4, 2e-4), None, timed=False)
            args = (*chip_smoke.spd_blocks(device, B=chip_smoke.BATCH, N=20,
                                           nx=nx, nu=nu),
                    torch.full((chip_smoke.BATCH,), 1e-6, device=device))
            ms = chip_smoke._kernel_ms(lambda: riccati_backward_bm(*args), 20)
            print(f"[team] name=riccati_bwd.{nx}x{nu} N=20 "
                  f"B={chip_smoke.BATCH} ms={ms:.5g} "
                  + " ".join(f"{k}={v}" for k, v in launch_geometry(
                      nx, nu, chip_smoke.BATCH).items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
