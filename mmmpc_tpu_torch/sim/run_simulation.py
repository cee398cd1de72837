"""Open-loop sim smoke test.

Counterpart of ``mmmpc_tpu/sim/run_simulation.py``: drive the plant with
a constant forward velocity for n steps and report the displacement — a
manual sanity check of the simulation backend.

    python -m mmmpc_tpu_torch.sim.run_simulation
"""

import numpy as np

from mmmpc_tpu_torch.sim.kinematic_plant import run_step, setup_environment


def run(env, n_steps=1000):
    action = np.zeros(env.n())
    action[0] = 0.2   # constant commanded forward velocity
    ob = None
    for _ in range(n_steps):
        ob = run_step(env, action)
    return ob


if __name__ == "__main__":
    env, ob0 = setup_environment(render=False, dt=0.01)
    ob = run(env, 1000)
    pos = ob["robot_0"]["joint_state"]["position"][:3]
    print("position after 10 s of constant v=0.2:", pos)
    # reversed-V sim convention: the robot backed up 2 m along +x heading
    assert abs(pos[0] - (-2.0)) < 1e-6, pos
    print("smoke test OK")
