"""Kernel C's per-scenario instance (K5) and its shared twin (C) of a parent
commit's sources and of this tree in turns, on one card.

    python3 k5_turns.py PARENT_CSRC

PARENT_CSRC is the parent commit's ``mmmpc_tpu_torch/csrc`` (unpacked with
``git archive``; the copy on the card is no git repository).  The script
builds each generic source (``generic_<name>.cu``) of both into a library of
its own, the same ``nvcc`` command for both, all started together, under
``build/torch_kernels/k5_turns/``, and prints:

- ``[ptxas-turns]``: each side's registers and spills of every C and K5
  instance;
- ``[sass-turns]``: whether each shared instance (C and D of each
  formulation) has the same SASS on both sides (``cuobjdump -sass``,
  addresses and encodings stripped; the kernels matched by kind and
  formulation, since the tree's line search takes one more argument);
- ``[turns]``: on the inputs of ``chip_smoke.py``'s phase-3 checks at batch
  8192 (C on each bench row, K5 with ``torch_problems.generic_fleet_params``:
  every entry a robot may own per robot), each instance's device ms a launch
  (a CUDA-graph replay of 20 launches, as ``[kernel]``) parent / tree /
  tree / parent, and each side's max abs errors against the same plain
  version (X / U, cost), held to phase 3's C tolerances.

The parent's K5 takes its params as one column a robot, (size, B), every
shared entry copied into each; the script packs that buffer as the parent's
wrapper did.  Exits nonzero if a build, a check or a launch fails.
"""

from __future__ import annotations

import ctypes
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from mmmpc_tpu_torch.ops import _cuda  # noqa: E402

OUT = _cuda.BUILD_DIR / "k5_turns"
SOURCES = tuple(dict.fromkeys(_cuda.FORMULATION_SOURCES.values()))
# the parent's K5 entry: the shared instance's arguments, its params (size, B)
PARENT_PS = [ctypes.c_void_p] * 13 + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
KINDS = {"23generic_fwd_team_kernelI": "fwd", "18generic_fwd_kernelI": "fwd",
         "23generic_bwd_team_kernelI": "bwd", "18generic_bwd_kernelI": "bwd"}


def build(sides):
    """One library a (side, source) from the csrc directories ``sides``
    ({side: dir}); returns ({(side, source): path}, {(side, source): log})."""
    procs = {}
    for side, csrc in sides.items():
        for src in SOURCES:
            out = OUT / f"lib{side}_{Path(src).stem}.so"
            procs[side, src] = (out, subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
                 str(Path(csrc) / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths, logs = {}, {}
    for key, (out, proc) in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{logs[key]}")
        paths[key] = out
    return paths, logs


def load(path, parent):
    """The library at ``path`` with the signatures of its generic entries
    (the parent's K5 entry with its own)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _cuda.SIGNATURES.items():
        if name.startswith("gen_") and hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = (PARENT_PS if parent and name.startswith("gen_fwd_ps_")
                           and not name.startswith("gen_fwd_ps_geometry")
                           else argtypes)
            fn.restype = ctypes.c_int
    return lib


def sass(path):
    """{(kind, formulation, per_scenario): SASS text without addresses and
    encodings} of the generic kernels in the library at ``path``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out, key = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            kind = next((v + ("_team" if "team" in k else "")
                         for k, v in KINDS.items() if k in name), None)
            f = next((f for f, t in cs.MANGLED.items() if t in name), None)
            key = None if kind is None or f is None else (
                kind, f, "11PerScenario" in name)
            if key is not None:
                out[key] = []
            continue
        if key is not None:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "",
                         ln).strip()
            if ins:
                out[key].append(ins)
    return {k: "\n".join(v) for k, v in out.items()}


def parent_columns(fwd, params):
    """The parent's K5 params: one column a robot, (size, B), a shared
    entry copied into every column (its wrapper's ``pack_columns``)."""
    parts = []
    for k, shape in fwd.form.shapes.items():
        t, n = params[k], math.prod(shape)
        parts.append(t.reshape(n, -1) if k in fwd.operands
                     else t.reshape(n, 1).expand(n, fwd.batch))
    return torch.cat(parts).contiguous()


def parent_call(lib, fwd, flat, fargs):
    """A call of the parent's entry of ``fwd``'s instance (K5 on the column
    buffer ``flat``, else C on the packed one) on ``fargs``: the outputs."""
    X, U, kff, K, lam, lamt, lame, mu = fargs
    N, na, B = fwd.ocp.N, len(fwd.alphas), X.shape[-1]
    kw = dict(dtype=torch.float32, device=X.device)
    outs = (torch.empty(N, na, fwd.ocp.nx, B, **kw),
            torch.empty(N, na, fwd.ocp.nu, B, **kw),
            torch.empty(na, fwd.ocp.nx, B, **kw), torch.empty(na, B, **kw))
    entry = f"gen_fwd_{'ps_' if fwd.ps_keys else ''}{fwd.form.name}"
    err = getattr(lib, entry)(
        fwd.statics.ctypes.data, flat.data_ptr(),
        *(a.data_ptr() for a in (X, U, kff, K, lam, lamt, lame)),
        *(o.data_ptr() for o in outs), float(mu), N, B,
        torch.cuda.current_stream().cuda_stream)
    _cuda.check_launch(f"parent {entry}", err)
    return outs


def main(argv):
    if len(argv) != 1 or not torch.cuda.is_available():
        print("k5_turns: usage: python3 k5_turns.py PARENT_CSRC (on a CUDA "
              "card)", file=sys.stderr)
        return 1
    from mmmpc_tpu_torch.ops.generic_fwd import LAUNCHES, LAUNCHES_PS
    from mmmpc_tpu_torch.utils.convert import params_from_numpy
    cs._test_problems_path()
    from torch_problems import generic_fleet_params

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[device] nvidia_smi={smi!r}", flush=True)
    device = torch.device("cuda", 0)
    OUT.mkdir(parents=True, exist_ok=True)
    paths, logs = build({"parent": Path(argv[0]), "tree": _cuda.CSRC})
    reports = {side: cs.ptxas_report("".join(
        v for (s, _), v in logs.items() if s == side))
        for side in ("parent", "tree")}
    for f in cs.GENERIC:
        for ps in (False, True):
            for side in ("parent", "tree"):
                print(f"[ptxas-turns] side={side} name=generic_fwd.{f}"
                      f"{'.per_scenario' if ps else ''} " + " ".join(
                          f"{k}={v}" for k, v in
                          cs.fwd_ptxas(reports[side], f, ps).items()),
                      flush=True)
    code = {side: {} for side in ("parent", "tree")}
    for (side, _), path in paths.items():
        code[side].update(sass(path))
    shared = sorted(k for k in code["parent"] if not k[2])
    for key in shared:
        print(f"[sass-turns] kernel={key[0]} formulation={key[1]} "
              f"identical={code['parent'][key] == code['tree'].get(key)}",
              flush=True)

    libs = {key: load(path, key[0] == "parent") for key, path in paths.items()}
    for row, f, mpc, x0, _, params in cs.generic_problems(cs.BATCH, device,
                                                          cs.PS_ROWS):
        src = _cuda.FORMULATION_SOURCES[f]
        for ps in (False, True):
            p = (params_from_numpy(generic_fleet_params(
                cs._np_params(params), cs.BATCH), device, torch.float32)
                 if ps else params)
            _cuda.LIBRARY.lib = libs["tree", src]
            fwd = mpc.ocp.lanes_fwd_factory(mpc.solver_config, p)
            fargs, _ = cs._generic_args(mpc, fwd.form, x0, p,
                                        np.random.default_rng(cs.SEED),
                                        device)
            flat = parent_columns(fwd, p) if ps else fwd.flat
            calls = {"parent": lambda: parent_call(libs["parent", src], fwd,
                                                   flat, fargs),
                     "tree": lambda: fwd.cuda(*fargs)}
            name = f"generic_fwd.{f}{'.per_scenario' if ps else ''}"
            counter = (LAUNCHES_PS if ps else LAUNCHES)[f]
            ref = fwd.plain(*fargs)
            errs = {}
            for side, call in calls.items():
                before = counter.cuda
                got = call()
                torch.cuda.synchronize()
                if side == "tree" and counter.cuda != before + 1:
                    raise AssertionError(f"{name}: the tree's wrapper did "
                                         f"not launch its kernel")
                errs[side] = cs._fwd_errors(f"{side} {name}", got, ref)
            ms = [cs._kernel_ms(calls[side], 20)
                  for side in ("parent", "tree", "tree", "parent")]
            print(f"[turns] name={name} row={row} N={mpc.N} B={cs.BATCH} "
                  f"ms_parent_tree_tree_parent="
                  f"{'/'.join(f'{m:.5g}' for m in ms)} "
                  + " ".join(f"{side}_err_XU={e[0]:.3e} "
                             f"{side}_err_cost={e[1]:.3e}"
                             for side, e in errs.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
