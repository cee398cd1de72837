"""Which device records a ``torch.profiler`` run drops, by the age of the
process, on the card.

At each age given (seconds since the script started; the card multiplies
4096 x 4096 matrices in between) it profiles, five times, ``N`` marker
kernels (``torch.cuda._sleep``) followed by ``N`` fills, device activity
only, as ``mmmpc_tpu_torch/profile_solver.py`` profiles a component, and
prints the records kept of each half: the markers are the first records a
run should hold, the fills the last.  The five runs differ in a wait on the
host: none, 20 ms after the profiler starts and before the first launch,
20 ms after the last synchronise and before the profiler stops, none,
200 ms before the first launch.  Needs a CUDA card:

    python3 profiler_drops.py [age ...]      # default: 0 60 180 360
"""

import sys
import time

import torch

N = 1024
WAITS = ((0.0, 0.0), (0.02, 0.0), (0.0, 0.02), (0.0, 0.0), (0.2, 0.0))


def run(before, after):
    """(markers kept, fills kept) of one profiler run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if before:
            time.sleep(before)
        for _ in range(N):
            torch.cuda._sleep(1)
        for _ in range(N):
            x.fill_(1.0)
        torch.cuda.synchronize()
        if after:
            time.sleep(after)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    markers = sum("spin_kernel" in n for n in names)
    return markers, len(names) - markers


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    ages = [float(a) for a in argv] or [0.0, 60.0, 180.0, 360.0]
    t0 = time.time()
    a = torch.randn(4096, 4096, device="cuda")
    for age in ages:
        while time.time() - t0 < age:
            for _ in range(50):
                a = (a @ a).tanh_()
            torch.cuda.synchronize()
        for before, after in WAITS:
            markers, fills = run(before, after)
            print(f"[profiler-drops] age_s={time.time() - t0:.0f} "
                  f"wait_before_s={before} wait_after_s={after} "
                  f"markers_kept={markers}/{N} fills_kept={fills}/{N}",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
