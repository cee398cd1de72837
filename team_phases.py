"""Where the time of the redesigned fused kernels goes, on the card: each
kernel built with one part of its work taken out.

No profiler that counts a kernel's stalls runs on the card's machine, so
this script times variants instead.  From ``mmmpc_tpu_torch/csrc`` it
builds kernel E (``riccati.cu``, its four pairs), kernels D.endpoint,
D.arm and D.base (``generic_endpoint.cu``, ``generic_arm.cu``,
``generic_base.cu``; D.base one thread a scenario on
``riccati_step.cuh``), the team line searches C.endpoint, C.arm and C.base
(``endpoint_fwd``, ``arm_fwd``, ``base_fwd``: ``generic_fwd.cuh`` with
those files' hooks) and the one-thread line search C.demo (``demo_fwd``,
with its stage ring) once as they are and once for each variant of
``VARIANTS``, the part taken out between preprocessor guards that the
script writes into a copy of the sources (one ``nvcc`` a library, all
started together, into ``build/torch_kernels/phases/``):

- ``no_loads``: the stage inputs are never copied into shared memory (the
  kernel computes on what the buffer or ring holds): the compute alone;
- ``no_step``: the team step is not run (the stage inputs still stream
  through the buffer): the loads and the barriers alone;
- ``no_rows``: the row tasks of the step (the Q-block products and the
  stage's own rows, for the team D kernels their expansion) are skipped;
  for the one-thread D.base, the Q-block products of ``riccati_step.cuh``;
- ``no_expansion`` (the D kernels): the stage's own rows are not added;
- ``no_update``: the value update and the symmetrisation are skipped;
- ``no_fk``, ``no_wedge``, ``no_self`` (D.arm and C.arm): the FK (its
  sincos and algebra), the wedge points, or the self-collision rows are not
  computed (zeros in their place);
- ``no_circles`` (D.base, one thread a scenario on ``riccati_step.cuh``
  with its stage buffer): the ground circles are not computed;
- ``no_sincos`` (C.base): the step's sincos is not computed (0 and 1 in
  its place);
- ``no_ground`` (C.endpoint, C.base): the ground circles are not computed;
  ``no_forms``: the stage's quadratic forms are not (C.endpoint's R and W,
  C.base's Q and R and its terminal's P, C.demo's Q and R); ``no_phr`` (the
  four line searches): the stage's PHR rows.

A variant's outputs are not the kernel's; only its time is read.  Each is
timed as ``chip_smoke.py``'s ``[kernel]`` (CUDA-graph replay of 20 launches)
at N=20, B=8192: E at each pair on random SPD blocks, the generic kernels
on the inputs of their ``[kernel]`` checks (``[phase-time]`` lines).  Needs
a CUDA card and ``nvcc``:

    python3 team_phases.py [KERNEL ...]

(KERNEL among the keys of ``SOURCE``; all by default.)

Exits nonzero if a build fails or a guard's anchor is not in the source.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import team_sweep  # noqa: E402
from mmmpc_tpu_torch.ops import _cuda  # noqa: E402

OUT = _cuda.BUILD_DIR / "phases"
# variant -> the kernels it applies to
VARIANTS = {"full": ("riccati", "endpoint", "arm", "base", "endpoint_fwd",
                     "arm_fwd", "base_fwd", "demo_fwd"),
            "no_loads": ("riccati", "endpoint", "arm", "base", "endpoint_fwd",
                         "arm_fwd", "base_fwd", "demo_fwd"),
            "no_step": ("riccati", "endpoint", "arm", "base"),
            "no_rows": ("riccati", "endpoint", "arm", "base"),
            "no_expansion": ("endpoint", "arm", "base"),
            "no_update": ("riccati", "endpoint", "arm", "base"),
            "no_fk": ("arm", "endpoint_fwd", "arm_fwd"),
            "no_wedge": ("arm", "arm_fwd"),
            "no_self": ("arm", "arm_fwd"),
            "no_circles": ("base",),
            "no_sincos": ("base_fwd",),
            "no_ground": ("endpoint_fwd", "base_fwd"),
            "no_forms": ("endpoint_fwd", "base_fwd", "demo_fwd"),
            "no_phr": ("endpoint_fwd", "arm_fwd", "base_fwd", "demo_fwd")}
SOURCE = {"riccati": "riccati.cu", "endpoint": "generic_endpoint.cu",
          "arm": "generic_arm.cu", "base": "generic_base.cu",
          "endpoint_fwd": "generic_endpoint.cu", "arm_fwd": "generic_arm.cu",
          "base_fwd": "generic_base.cu", "demo_fwd": "generic_demo.cu"}
# (file, text the guard starts before, text it ends after or before, macro,
# and optionally the text in its place); a guard whose end is None takes
# one statement: the start text itself
GUARDS = (
    ("riccati_team.cuh", "  float acc[R][NX], uu[R][NU], q[R];",
     "  // ---- Cholesky of Quu + reg I in every lane", "NO_ROWS"),
    ("riccati_team.cuh", "  rows(q, acc, uu);\n", None, "NO_EXPANSION"),
    ("riccati_team.cuh", "  float gc[R2][NU];", "}\n\n}  // namespace ric",
     "NO_UPDATE"),
    ("riccati.cu", "    team_step<NX, NU, T>(", "  }\n}\n\n// The launch",
     "NO_STEP"),
    ("generic_bwd.cuh", "    ric::team_step<NX, NU, T>(", "  }\n}\n\n// The launch",
     "NO_STEP"),
    ("generic_arm.cu", "      fk_team<T>(x, lane, a);\n", None, "NO_FK",
     "      a = wb::ArmFK{};\n"),
    ("generic_arm.cu", "      sm = wedge_team<T>(a, c, lane, sq);\n", None,
     "NO_WEDGE", "      sm = sq[0] = sq[1] = sq[2] = 0.f;\n"),
    ("generic_arm.cu", "      self_team<T>(a, lane, sv, sg);\n", None,
     "NO_SELF", "      for (int r = 0; r < 4; ++r)\n"
     "        sv[r] = sg[r][0] = sg[r][1] = sg[r][2] = 0.f;\n"),
    ("generic_endpoint.cu", "    sincos_team<T, 4>(\n", "    using namespace wb;",
     "NO_FK",
     "    for (int i = 0; i < 4; ++i) s[i] = cs[i] = 0.f;\n"),
    ("generic_endpoint.cu",
     "    const float sm = ground_value_team<T>(c, c.L.obs, x[0], x[1], "
     "c.ex(S_RADIUS), lane);\n", None, "NO_GROUND", "    const float sm = 0.f;\n"),
    ("generic_endpoint.cu",
     "    tr += qform_rows<T, NU>(c.mat(c.L.R), eu, v + FV_EU, lane);\n",
     "    const float pen = phr_rows<T, NC>", "NO_FORMS"),
    ("generic_endpoint.cu",
     "    const float pen = phr_rows<T, NC>(rt, v, lam, SC, mu, lane);\n",
     None, "NO_PHR", "    const float pen = 0.f;\n"),
    ("generic_arm.cu", "    wb::ArmFK a;\n    fk_team<T>(x, lane, a);\n", None,
     "NO_FK", "    wb::ArmFK a{};\n"),
    ("generic_arm.cu",
     "    const float sm = wedge_value_team<T>(a, c, lane);\n", None,
     "NO_WEDGE", "    const float sm = 0.f;\n"),
    ("generic_arm.cu", "    self_value_team<T>(a, lane, v);\n", None,
     "NO_SELF"),
    ("generic_arm.cu",
     "    const float pen = phr_rows<T, NC>(rt, v, lam, SC, mu, lane);\n",
     None, "NO_PHR", "    const float pen = 0.f;\n"),
    # C.base and C.demo
    ("generic_base.cu", "    sincosf(x[2], &sn, &cs);\n", None, "NO_SINCOS",
     "    sn = 0.f;\n    cs = 1.f;\n"),
    ("generic_base.cu",
     "    const float sm = ground_value_team<T>(c, c.L.obs, x[0], x[1], "
     "c.ex(S_RADIUS), lane);\n", None, "NO_GROUND", "    const float sm = 0.f;\n"),
    ("generic_base.cu",
     "    return tr + qform_rows<T, NX>(W, e, v + FV_E, lane);\n", None,
     "NO_FORMS", "    return tr;\n"),
    ("generic_base.cu",
     "    tr += qform_rows<T, NU>(c.mat(c.L.R), eu, v + FV_EU, lane);\n",
     None,
     "NO_FORMS"),
    ("generic_base.cu",
     "    const float pen = phr_rows<T, NC>(rt, v, lam, SC, mu, lane);\n",
     None, "NO_PHR", "    const float pen = 0.f;\n"),
    ("generic_demo.cu",
     "    return qform<2>(c.wq(), ex) + qform<1>(c.mat(c.L.R), eu);\n",
     None,
     "NO_FORMS", "    return 0.f;\n"),
    ("generic_fwd.cuh",
     "    for (int r = 0; r < NC; ++r) {\n"
     "      const float l = in[(In::LAM + r) * S];\n", "    acc += c.inv_scale",
     "NO_PHR"),
    # D.base: the one-thread kernel on riccati_step.cuh
    ("riccati_step.cuh", "  // ---- Q blocks of the next value function.",
     "  // ---- + the stage's own blocks", "NO_ROWS"),
    ("riccati_step.cuh", "  add_stage();\n", None, "NO_EXPANSION"),
    ("riccati_step.cuh", "  // ---- value update (Quu without reg):",
     "}\n\n}  // namespace ric", "NO_UPDATE"),
    ("generic_bwd.cuh", "    ric::riccati_step<NX, NU>(",
     "  }\n}\n\n// ---------------- the team kernel", "NO_STEP"),
    ("generic_base.cu",
     "    const float sm = ground_slack(c, c.L.obs, x[0], x[1], "
     "c.ex(S_RADIUS), sxy);\n", None, "NO_CIRCLES",
     "    const float sm = 0.f;\n    sxy[0] = sxy[1] = 0.f;\n"),
)
LOADS = (("riccati.cu", "  auto issue_stage = [&](int k) {\n"),
         ("generic_bwd.cuh", "  auto issue_stage = [&](int k) {\n"),
         ("generic_fwd.cuh", "  auto issue_stage = [&](int k) {\n"))


def guarded_sources(dst: Path) -> None:
    """A copy of ``csrc`` at ``dst`` with the guards of ``GUARDS`` and an
    early return from each kernel's stage copy under ``NO_LOADS``."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(_cuda.CSRC, dst)
    for name, start, end, macro, *alt in GUARDS:
        path = dst / name
        s = path.read_text()
        a = s.find(start)
        b = a + len(start) if end is None else s.find(end, a)
        if a < 0 or b < 0:
            raise ValueError(f"{name}: no anchor for {macro}")
        other = f"#else\n{alt[0]}" if alt else ""
        path.write_text(f"{s[:a]}#ifndef {macro}\n{s[a:b]}\n{other}#endif\n"
                        f"{s[b:]}")
    for name, start in LOADS:
        path = dst / name
        s = path.read_text()
        if start not in s:
            raise ValueError(f"{name}: no anchor for NO_LOADS")
        path.write_text(s.replace(
            start, start + "#ifdef NO_LOADS\n    return;\n#endif\n"))


def build(only=tuple(SOURCE)):
    """One library a (variant, kernel) of the kernels ``only``; returns
    (variant, kernel) -> path."""
    src = OUT / "src"
    guarded_sources(src)
    procs = {}
    for variant, kernels in VARIANTS.items():
        flag = [] if variant == "full" else [f"-D{variant.upper()}"]
        for kernel in (k for k in kernels if k in only):
            procs[variant, kernel] = subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flag, "-shared", "-o",
                 str(OUT / f"lib{kernel}_{variant}.so"),
                 str(src / SOURCE[kernel])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (variant, kernel), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} {variant}:\n{log}")
    return {v: OUT / f"lib{v[1]}_{v[0]}.so" for v in procs}


def main(argv):
    if not torch.cuda.is_available():
        print("team_phases: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from mmmpc_tpu_torch.ops.riccati import riccati_backward_bm

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[device] nvidia_smi={smi!r}", flush=True)
    device = torch.device("cuda", 0)
    OUT.mkdir(parents=True, exist_ok=True)
    only = tuple(argv) or tuple(SOURCE)
    libs = build(only)
    # each generic kernel's (wrapper, arguments): a forward kernel's line
    # search, a backward kernel's fused backward
    rows = {k: team_sweep.row_args(device, team_sweep.FORMULATION[k])[
        (0 if k.endswith("_fwd") else 1)::2] for k in only if k != "riccati"}
    blocks = {dims: (*chip_smoke.spd_blocks(device, B=chip_smoke.BATCH, N=20,
                                            nx=dims[0], nu=dims[1]),
                     torch.full((chip_smoke.BATCH,), 1e-6, device=device))
              for dims in _cuda.RICCATI_INSTANCES}
    for (variant, kernel), path in libs.items():
        _cuda.LIBRARY.lib = team_sweep.load(kernel, path)
        if kernel in rows:
            f, args = rows[kernel]
            ms = chip_smoke._kernel_ms(lambda: f.cuda(*args), 20)
            name = ("generic_fwd." if kernel.endswith("_fwd")
                    else "generic_bwd.") + team_sweep.FORMULATION[kernel]
            print(f"[phase-time] name={name} variant={variant} ms={ms:.5g}",
                  flush=True)
            continue
        for (nx, nu), args in blocks.items():
            ms = chip_smoke._kernel_ms(lambda: riccati_backward_bm(*args), 20)
            print(f"[phase-time] name=riccati_bwd.{nx}x{nu} variant={variant} "
                  f"ms={ms:.5g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
