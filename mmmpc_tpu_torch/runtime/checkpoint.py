"""Checkpoint / resume of solver and closed-loop state (counterpart of
``mmmpc_tpu/runtime/checkpoint.py``).

- ``SolverState``: the warm start of one controller -- its last inputs and
  shifted multipliers -- and the terminal-equality mask;
- ``LoopState``: plant state, integrated velocity command, task phase and
  tick counters of a closed-loop run (``runtime/interface.py``).

Stored as flat npz.  The JAX package's ``SolverState`` keeps the inputs
only, so a resumed JAX loop starts its multipliers from zero; this one
keeps the multipliers too, so the tick after a restore repeats the
uninterrupted run's exactly.  ``restore`` puts the warm start back on the
controller's device in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_LAMS = ("lam_stage", "lam_term", "lam_eq")


@dataclasses.dataclass
class SolverState:
    """Warm-start state of a receding-horizon controller."""
    u_latest: Optional[np.ndarray]          # (N, nu) or None
    lam_stage: Optional[np.ndarray] = None  # (N, nc) or None
    lam_term: Optional[np.ndarray] = None   # (nct,) or None
    lam_eq: Optional[np.ndarray] = None     # (ne,) or None
    terminal_eq_mask: float = 0.0

    @staticmethod
    def capture(controller) -> "SolverState":
        def host(t):
            return None if t is None else t.cpu().numpy()

        lams = controller.lam_latest or (None,) * len(_LAMS)
        return SolverState(
            u_latest=host(controller.u_latest),
            **{k: host(v) for k, v in zip(_LAMS, lams)},
            terminal_eq_mask=float(getattr(controller, "terminal_eq_mask",
                                           0.0)))

    def restore(self, controller):
        def device(a):
            return torch.as_tensor(a, dtype=torch.float32,
                                   device=controller.device)

        controller.u_latest = (None if self.u_latest is None
                               else device(self.u_latest))
        lams = [getattr(self, k) for k in _LAMS]
        controller.lam_latest = (None if any(v is None for v in lams)
                                 else tuple(device(v) for v in lams))
        if hasattr(controller, "terminal_eq_mask"):
            controller.terminal_eq_mask = self.terminal_eq_mask


@dataclasses.dataclass
class LoopState:
    """Resumable closed-loop (Interface) state."""
    current_state: np.ndarray
    task_flag: str
    mpc_step_counter: int
    timer_counter: int
    vel_command_base: Optional[np.ndarray]
    traj_ref: Optional[np.ndarray]
    u_ref: Optional[np.ndarray]
    solver: SolverState

    @staticmethod
    def capture(interface) -> "LoopState":
        return LoopState(
            current_state=np.asarray(interface.current_state),
            task_flag=interface.task_flag,
            mpc_step_counter=interface.mpc_step_counter,
            timer_counter=interface.timer_counter,
            vel_command_base=(np.asarray(interface.vel_command_base)
                              if interface.physical_sim else None),
            traj_ref=(None if interface.traj_ref is None
                      else np.asarray(interface.traj_ref)),
            u_ref=(None if interface.u_ref is None
                   else np.asarray(interface.u_ref)),
            solver=SolverState.capture(interface.controller))

    def restore(self, interface):
        interface.current_state = self.current_state.copy()
        interface.task_flag = self.task_flag
        interface.mpc_step_counter = self.mpc_step_counter
        interface.timer_counter = self.timer_counter
        if self.vel_command_base is not None:
            interface.vel_command_base = self.vel_command_base.copy()
        interface.traj_ref = (None if self.traj_ref is None
                              else self.traj_ref.copy())
        interface.u_ref = (None if self.u_ref is None
                           else self.u_ref.copy())
        self.solver.restore(interface.controller)


def save(path, state: LoopState | SolverState):
    """Serialize a checkpoint dataclass to npz."""
    flat = {}

    def put(prefix, obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            key = f"{prefix}{f.name}"
            if dataclasses.is_dataclass(v):
                put(key + ".", v)
            elif v is None:
                flat[key + ".__none__"] = np.asarray(0)
            elif isinstance(v, str):
                flat[key + ".__str__"] = np.asarray(v)
            else:
                flat[key] = np.asarray(v)

    flat["__type__"] = np.asarray(type(state).__name__)
    put("", state)
    np.savez(path, **flat)


def load(path):
    """Deserialize a checkpoint written by save()."""
    data = dict(np.load(path, allow_pickle=False))
    typename = str(data.pop("__type__"))
    cls = {"LoopState": LoopState, "SolverState": SolverState}[typename]

    def build(cls, prefix):
        kwargs = {}
        for f in dataclasses.fields(cls):
            key = f"{prefix}{f.name}"
            if f.name == "solver" and cls is LoopState:
                kwargs[f.name] = build(SolverState, key + ".")
            elif key + ".__none__" in data:
                kwargs[f.name] = None
            elif key + ".__str__" in data:
                kwargs[f.name] = str(data[key + ".__str__"])
            else:
                v = data[key]
                kwargs[f.name] = v.item() if v.ndim == 0 else v
        return cls(**kwargs)

    return build(cls, "")
