"""The refined qref solve under five roundings of kernel B's reciprocal
square roots, on the card.

Kernel B (``mmmpc_tpu_torch/csrc/wholebody_bwd.cu``) takes 1 / sqrt in the
ground-circle and self-collision rows of the slack group (1 / d, -1 / n, and
the half-plane rows' 1 / count beside them) and at the Cholesky pivots.  The
source uses ``rsqrt_nr`` (the hardware estimate and one Newton step) at both.
From that source this script builds a library of kernels A and B for each
variant of B:

- ``shipped``: the source as it is;
- ``bare``: the bare estimate ``rsqrtf`` in the rows and the Cholesky;
- ``exact``: correctly rounded ``sqrtf`` and division in both;
- ``exact_items``: correctly rounded in the rows, the bare estimate in the
  Cholesky;
- ``exact_chol``: the bare estimate in the rows, correctly rounded in the
  Cholesky;

and for each runs ``chip_smoke.py``'s checks of B (``[kernel]``,
``[kernel-batch]``) and its slice phase (``[slice]``, ``[bar]``: the
converged fraction and the max violation at batch 8192).  The libraries are
built into ``build/torch_kernels/rounding/``, one ``nvcc`` a variant, all
started together.  Needs a CUDA card and ``nvcc``:

    python3 bwd_rounding_variants.py [variant ...]

Exits nonzero if a build or a phase fails; a missed bar is printed, not a
failure.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from mmmpc_tpu_torch.ops import _cuda  # noqa: E402

OUT = _cuda.BUILD_DIR / "rounding"

ITEMS = {
    "nr": [],
    "bare": [("rsqrt_nr(q)", "rsqrtf(q)")],
    "exact": [
        ("  const float id = rsqrt_nr(q);   // 1 / d\n"
         "  const float d = q * id;", "  const float d = sqrtf(q);"),
        ("  g[0] = -dx * id;\n  g[1] = -dy * id;",
         "  g[0] = -dx / d;\n  g[1] = -dy / d;"),
        ("  const float in = -rsqrt_nr(q);  // -1 / n\n"
         "  const float n = -q * in;", "  const float n = sqrtf(q);"),
        ("{v3[0] * in, v3[1] * in, v3[2] * in}",
         "{-v3[0] / n, -v3[1] / n, -v3[2] / n}"),
        ("{nsum[0] * ic, nsum[1] * ic, nsum[2] * ic}",
         "{nsum[0] / cnt, nsum[1] / cnt, nsum[2] / cnt}"),
    ],
}
CHOL = {
    "nr": [],
    "bare": [("Dinv[i] = rsqrt_nr(s);", "Dinv[i] = rsqrtf(s);")],
    "exact": [("            Dinv[i] = rsqrt_nr(s);\n"
               "            Lc[i][i] = s * Dinv[i];",
               "            const float r = sqrtf(s);\n"
               "            Dinv[i] = 1.f / r;\n"
               "            Lc[i][i] = r;")],
}
# variant -> (rounding in the rows, rounding in the Cholesky)
VARIANTS = {"shipped": ("nr", "nr"), "bare": ("bare", "bare"),
            "exact": ("exact", "exact"), "exact_items": ("exact", "bare"),
            "exact_chol": ("bare", "exact")}


def variant_source(name: str) -> str:
    src = (_cuda.CSRC / "wholebody_bwd.cu").read_text()
    items, chol = VARIANTS[name]
    for old, new in ITEMS[items] + CHOL[chol]:
        if old not in src:
            raise ValueError(f"{name}: {old!r} is not in wholebody_bwd.cu")
        src = src.replace(old, new)
    return src


def build(names):
    """One library (kernels A and B) a variant; returns name -> path."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = OUT / f"{name}.cu"
        src.write_text(variant_source(name))
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I", str(_cuda.CSRC),
             "-o", str(OUT / f"lib{name}.so"), str(src),
             str(_cuda.CSRC / "wholebody_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[ptxas] variant={name} {ln.strip()}", flush=True)
    return {name: OUT / f"lib{name}.so" for name in names}


def load(path):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _cuda.SIGNATURES.items():
        if name.startswith("wb_"):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def main(argv):
    if not torch.cuda.is_available():
        print("bwd_rounding_variants: no CUDA card", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"bwd_rounding_variants: no variant {sorted(unknown)}; one of "
              f"{', '.join(VARIANTS)}", file=sys.stderr)
        return 2
    import chip_smoke
    from mmmpc_tpu_torch.bench import SOLVER_CFG, build_problem

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[device] nvidia_smi={smi!r}", flush=True)
    device = torch.device("cuda", 0)
    failed = []
    for name, path in build(names).items():
        _cuda.LIBRARY.lib = load(path)
        items, chol = VARIANTS[name]
        print(f"[variant] name={name} rows={items} cholesky={chol}", flush=True)
        try:
            mpc, x0, _, params = build_problem(chip_smoke.BATCH, device)
            chip_smoke.check_wholebody(mpc, x0, params, SOLVER_CFG, device,
                                       None, {"wholebody_bwd"})
            chip_smoke.run_slice(device)
        except Exception as e:  # noqa: BLE001 - report, go on to the next
            print(f"[variant-failed] name={name} error={e!r}", flush=True)
            failed.append(name)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
