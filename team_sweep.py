"""The kernels on a team of lanes at each team size, on the card.

Kernel E, ``mmmpc_tpu_torch/csrc/riccati.cu``, takes its lanes a scenario
from one rule, ``ric_team(nx, nu)``; kernels D.endpoint and D.arm
(``csrc/generic_endpoint.cu``, ``csrc/generic_arm.cu``) from their
formulation's ``BWD_TEAM``, and kernels C.endpoint and C.arm from their
formulation's ``FWD_TEAM`` (lanes a candidate).  From those sources this
script builds, for each size T of ``TEAMS``, a library of each kernel of
``RULES`` (the rule replaced by T), one ``nvcc`` a library, all started
together, into ``build/torch_kernels/teams/``, prints each build's ptxas
registers and spills, and for each T:

- E at each pair against its plain version on the Pallas test's random SPD
  blocks (N=4, B=1024) at rtol = atol = 2e-4 (its ``[kernel]`` line), and
  its device time per launch at N=20, B=8192 on random SPD blocks of that
  horizon (CUDA-graph replay of 20 launches, as ``chip_smoke.py``'s
  ``[kernel]``), with the launch geometry and the blocks an SM holds
  (``[team]``);
- the generic kernels on the inputs of ``chip_smoke.py``'s ``[kernel]``
  check of their row at batch 8192, against their plain versions at its
  tolerances (gains rtol 1e-4 with atol 2e-4 for D.endpoint, 1e-3 for
  D.base; D.arm the p99 / float64 form; C X / U atol 2e-5, cost rtol =
  atol 2e-3), and their device time per launch, with the launch geometry
  (``[team]``).

The ``*_1t`` kernels of ``RULES`` are one-thread kernels at T threads a
block, not lanes: C.arm's and D.base's (the latter also in its stage
buffer's stride), a control for a redesign.  They run only when ``--only``
names them, on the sources of ``--csrc DIR`` (the parent's ``csrc``, from
``git archive``) where the kernel is no longer one thread a scenario.

Needs a CUDA card and ``nvcc``:

    python3 team_sweep.py [--only KERNEL,...] [--csrc DIR] [T ...]

(``--only`` takes names of ``RULES``.)  Exits nonzero if a build or a check
fails.
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
_FWD_1T = ("    return {1, 128, static_cast<int>((total + 127) / 128), 0};\n",
           "    return {{1, {T}, static_cast<int>((total + {T} - 1) / {T}), "
           "0}};\n")
# each kernel: (its source, the file that holds its rule, ((the rule's
# lines, their text at size T), ...): the first pair whose lines the file
# holds).  The size is the team's lanes, or for a one-thread kernel
# (``*_1t``) the threads of its block: a control for a redesign, run on the
# parent's sources (``--csrc``).
RULES = {
    "riccati": ("riccati.cu", "riccati.cu",
                (("  int t = 1;\n"
                  "  while (4 * t < nx + nu && t < 8) t *= 2;\n"
                  "  return t;\n", "  return {T};\n"),)),
    "endpoint": ("generic_endpoint.cu", "generic_endpoint.cu",
                 (("  static constexpr int BWD_TEAM = 8;\n",
                   "  static constexpr int BWD_TEAM = {T};\n"),)),
    "arm": ("generic_arm.cu", "generic_arm.cu",
            (("  static constexpr int BWD_TEAM = 4;\n",
              "  static constexpr int BWD_TEAM = {T};\n"),)),
    "endpoint_fwd": ("generic_endpoint.cu", "generic_endpoint.cu",
                     (("  static constexpr int FWD_TEAM = 2;\n",
                       "  static constexpr int FWD_TEAM = {T};\n"),)),
    "arm_fwd": ("generic_arm.cu", "generic_arm.cu",
                (("  static constexpr int FWD_TEAM = 2;\n",
                  "  static constexpr int FWD_TEAM = {T};\n"),)),
    "arm_fwd_1t": ("generic_arm.cu", "generic_fwd.cuh", (_FWD_1T,)),
    "base_1t": ("generic_base.cu", "generic_bwd.cuh",
                (("constexpr int BWD_THREADS = 128;\n",
                  "constexpr int BWD_THREADS = {T};\n"),
                 ("    return {1, 128, (B + 127) / 128, 0};\n",
                  "    return {{1, {T}, (B + {T} - 1) / {T}, 0}};\n"))),
}
# the formulation of each generic kernel of this script and of
# team_phases.py (a line search's name holds _fwd), and the bench row of
# each formulation
FORMULATION = {"endpoint": "endpoint", "arm": "arm", "base": "base",
               "endpoint_fwd": "endpoint", "arm_fwd": "arm",
               "arm_fwd_1t": "arm", "base_1t": "base"}
ROW = {"endpoint": "wholebody_endpoint", "arm": "arm_only",
       "base": "base_only"}


def build(teams, kernels=tuple(RULES), csrc=_cuda.CSRC):
    """One library of each kernel a size, from the sources ``csrc``;
    returns (kernel, T) -> path."""
    procs = {}
    for kernel in kernels:
        src_name, rule_file, rules = RULES[kernel]
        for team in teams:
            src_dir = OUT / f"{kernel}_T{team}"
            if src_dir.exists():
                shutil.rmtree(src_dir)
            shutil.copytree(csrc, src_dir)
            text = (src_dir / rule_file).read_text()
            rule = next((r for r in rules if r[0] in text), None)
            if rule is None:
                raise ValueError(f"{rule_file}: the rule of {kernel} is not "
                                 f"as expected")
            (src_dir / rule_file).write_text(
                text.replace(rule[0], rule[1].format(T=team)))
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
    prefix = "ric_" if kernel == "riccati" else "gen_"
    for name, argtypes in _cuda.SIGNATURES.items():
        if name.startswith(prefix) and (
                kernel == "riccati"
                or name.endswith(f"_{FORMULATION[kernel]}")):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def row_args(device, name):
    """The line search and fused backward of formulation ``name``'s bench
    row at batch 8192 and their arguments, made as
    ``chip_smoke.check_generic`` makes them: (fwd, bwd, fargs, bargs)."""
    import numpy as np

    import chip_smoke
    from mmmpc_tpu_torch.bench_controllers import problems
    from mmmpc_tpu_torch.solver.al_ilqr import rollout

    for row, mpc, x0, _, params in problems(chip_smoke.BATCH, device):
        if row != ROW[name]:
            continue
        rng = np.random.default_rng(chip_smoke.SEED)
        N, B, nx, nu = mpc.N, chip_smoke.BATCH, mpc.NX, mpc.NU
        fwd = mpc.ocp.lanes_fwd_factory(mpc.solver_config, params)
        bwd = mpc.ocp.lanes_bwd_factory(mpc.solver_config, params)
        nc, nct = bwd.form.nc, bwd.form.nct

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        X, U = rollout(mpc.ocp, x0.T,
                       t(0.3 * rng.standard_normal((N, nu, B))), params)
        lame = t(np.zeros((0, B)))
        fargs = (X[:-1], U, t(0.05 * rng.standard_normal((N, nu, B))),
                 t(0.05 * rng.standard_normal((N, nu, nx, B))),
                 t(np.abs(rng.standard_normal((N, nc, B)))),
                 t(np.abs(rng.standard_normal((nct, B)))), lame, 10.0)
        bargs = (X, U, t(0.3 * np.abs(rng.standard_normal((N, nc, B)))),
                 t(0.3 * np.abs(rng.standard_normal((nct, B)))), lame, 10.0,
                 torch.full((B,), 1e-6, device=device))
        return fwd, bwd, fargs, bargs
    raise ValueError(f"no {ROW[name]} row")


def check_generic(kernel, team, fwd, bwd, fargs, bargs):
    """One team size of a generic kernel against its plain version at its
    ``[kernel]`` tolerance: (name, max abs error, the call that launches
    it, the launch geometry)."""
    import chip_smoke
    from mmmpc_tpu_torch.ops import generic_bwd, generic_fwd
    from mmmpc_tpu_torch.ops.generic_bwd import plain_bwd

    f = FORMULATION[kernel]
    tag = f"{kernel} T={team}"
    lib = _cuda.LIBRARY.lib
    if "_fwd" in kernel:
        got, ref = fwd.cuda(*fargs), fwd.plain(*fargs)
        torch.cuda.synchronize()
        err = max(chip_smoke._fwd_errors(tag, got, ref))
        return (f"generic_fwd.{f}", err, lambda: fwd.cuda(*fargs),
                generic_fwd.launch_geometry(
                    lib, f, fwd.ocp.N, fwd.form.n_obs, fwd.form.n_hp,
                    len(fwd.alphas), chip_smoke.BATCH))
    got, ref = bwd.cuda(*bargs), bwd.plain(*bargs)
    torch.cuda.synchronize()
    if f == "arm":
        truth = plain_bwd(bwd.ocp, {k: v.double() for k, v in
                                    bwd.form.unpack(bwd.flat).items()},
                          bwd.inv_scale,
                          *(a.double() if torch.is_tensor(a) else a
                            for a in bargs))
        err = chip_smoke._check_f64(tag, got, ref, truth)
    else:
        chip_smoke._test_problems_path()
        from torch_problems import BWD_ATOL
        err = chip_smoke._gains_check(tag, 1e-4, BWD_ATOL[f])(got, ref, bargs)
    return (f"generic_bwd.{f}", err, lambda: bwd.cuda(*bargs),
            generic_bwd.launch_geometry(lib, f, bwd.ocp.N, bwd.form.n_obs,
                                        bwd.form.n_hp, chip_smoke.BATCH))


def main(argv):
    if not torch.cuda.is_available():
        print("team_sweep: no CUDA card", file=sys.stderr)
        return 1
    kernels = tuple(k for k in RULES if not k.endswith("_1t"))
    csrc = _cuda.CSRC
    while argv[:1] in (["--only"], ["--csrc"]):
        if argv[0] == "--only":
            kernels = tuple(argv[1].split(","))
        else:
            csrc = Path(argv[1]).resolve()
        argv = argv[2:]
    teams = [int(a) for a in argv] or list(TEAMS)
    import chip_smoke
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
    libs = build(teams, kernels, csrc)
    rows = {f: row_args(device, f) for f in
            {FORMULATION[k] for k in kernels if k != "riccati"}}
    for kernel in kernels:
        if kernel == "riccati":
            continue
        for team in teams:
            _cuda.LIBRARY.lib = load(kernel, libs[kernel, team])
            name, err, call, geometry = check_generic(
                kernel, team, *rows[FORMULATION[kernel]])
            ms = chip_smoke._kernel_ms(call, 20)
            print(f"[team] name={name} kernel={kernel} N=20 "
                  f"B={chip_smoke.BATCH} max_abs_err={err:.4g} ms={ms:.5g} "
                  + " ".join(f"{k}={v}" for k, v in geometry.items()),
                  flush=True)
    if "riccati" not in kernels:
        return 0
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
