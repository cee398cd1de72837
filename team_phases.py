"""Where the time of the two kernels on the team Riccati step goes, on the
card: each kernel built with one part of its work taken out.

No profiler that counts a kernel's stalls runs on the card's machine, so
this script times variants instead.  From ``mmmpc_tpu_torch/csrc`` it
builds kernel E (``riccati.cu``, its four pairs) and kernel D.endpoint
(``generic_endpoint.cu``) once as they are and once for each variant of
``VARIANTS``, the part taken out between preprocessor guards that the
script writes into a copy of the sources (one ``nvcc`` a library, all
started together, into ``build/torch_kernels/phases/``):

- ``no_loads``: the stage inputs are never copied into shared memory (the
  kernel computes on what the buffer holds): the compute alone;
- ``no_step``: the team step is not run (the stage inputs still stream
  through the buffer): the loads and the barriers alone;
- ``no_rows``: the row tasks of the step (the Q-block products and the
  stage's own rows, for D.endpoint its expansion) are skipped;
- ``no_expansion`` (D.endpoint only): the stage's own rows are not added;
- ``no_update``: the value update and the symmetrisation are skipped.

A variant's outputs are not the kernel's; only its time is read.  Each is
timed as ``chip_smoke.py``'s ``[kernel]`` (CUDA-graph replay of 20 launches)
at N=20, B=8192: E at each pair on random SPD blocks, D.endpoint on the
inputs of its ``[kernel]`` check (``[phase-time]`` lines).  Needs a CUDA
card and ``nvcc``:

    python3 team_phases.py

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
VARIANTS = {"full": ("riccati", "endpoint"),
            "no_loads": ("riccati", "endpoint"),
            "no_step": ("riccati", "endpoint"),
            "no_rows": ("riccati", "endpoint"),
            "no_expansion": ("endpoint",),
            "no_update": ("riccati", "endpoint")}
SOURCE = {"riccati": "riccati.cu", "endpoint": "generic_endpoint.cu"}
# (file, text the guard starts before, text it ends after or before, macro);
# a guard whose end is None takes one statement: the start text itself
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
)
LOADS = (("riccati.cu", "  auto issue_stage = [&](int k) {\n"),
         ("generic_bwd.cuh", "  auto issue_stage = [&](int k) {\n"))


def guarded_sources(dst: Path) -> None:
    """A copy of ``csrc`` at ``dst`` with the guards of ``GUARDS`` and an
    early return from each kernel's stage copy under ``NO_LOADS``."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(_cuda.CSRC, dst)
    for name, start, end, macro in GUARDS:
        path = dst / name
        s = path.read_text()
        a = s.find(start)
        b = a + len(start) if end is None else s.find(end, a)
        if a < 0 or b < 0:
            raise ValueError(f"{name}: no anchor for {macro}")
        path.write_text(f"{s[:a]}#ifndef {macro}\n{s[a:b]}\n#endif\n{s[b:]}")
    for name, start in LOADS:
        path = dst / name
        s = path.read_text()
        if start not in s:
            raise ValueError(f"{name}: no anchor for NO_LOADS")
        path.write_text(s.replace(
            start, start + "#ifdef NO_LOADS\n    return;\n#endif\n"))


def build():
    """One library a (variant, kernel); returns (variant, kernel) -> path."""
    src = OUT / "src"
    guarded_sources(src)
    procs = {}
    for variant, kernels in VARIANTS.items():
        flag = [] if variant == "full" else [f"-D{variant.upper()}"]
        for kernel in kernels:
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


def main():
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
    libs = build()
    bwd, bargs = team_sweep.endpoint_args(device)
    blocks = {dims: (*chip_smoke.spd_blocks(device, B=chip_smoke.BATCH, N=20,
                                            nx=dims[0], nu=dims[1]),
                     torch.full((chip_smoke.BATCH,), 1e-6, device=device))
              for dims in _cuda.RICCATI_INSTANCES}
    for (variant, kernel), path in libs.items():
        _cuda.LIBRARY.lib = team_sweep.load(kernel, path)
        if kernel == "endpoint":
            ms = chip_smoke._kernel_ms(lambda: bwd.cuda(*bargs), 20)
            print(f"[phase-time] name=generic_bwd.endpoint variant={variant} "
                  f"ms={ms:.5g}", flush=True)
            continue
        for (nx, nu), args in blocks.items():
            ms = chip_smoke._kernel_ms(lambda: riccati_backward_bm(*args), 20)
            print(f"[phase-time] name=riccati_bwd.{nx}x{nu} variant={variant} "
                  f"ms={ms:.5g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
