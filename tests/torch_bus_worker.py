"""Child process for tests/test_torch_transport.py: one node of the port
over its own UDP bus, talking to the parent only through datagrams.
Imports only the port.  Prints its bound port first, so that the parent
can peer with it.

    python tests/torch_bus_worker.py echo PARENT_PORT N_MSGS [native]
        republishes every /ping payload + 1 on /pong, N_MSGS times
        (native: over NativeUdpBus);
    python tests/torch_bus_worker.py fsm PARENT_PORT ITEMS TARGETS DT
        runs the mission FSM executive off incoming /env_obs until DONE
        (prints "DONE") or 60 s.
"""
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from alore_legged_manipulator_tpu_torch.runtime.transport import (  # noqa: E402
    UdpBus)


def echo(parent_port, n_msgs, native=False):
    if native:
        from alore_legged_manipulator_tpu_torch.runtime.native_transport import (
            NativeUdpBus as Bus)
    else:
        Bus = UdpBus
    bus = Bus(peers=[("127.0.0.1", parent_port)])
    print(bus.address[1], flush=True)
    done = threading.Event()
    count = [0]

    def on_ping(arr):
        bus.publish("/pong", np.asarray(arr) + 1.0)
        count[0] += 1
        if count[0] >= n_msgs:
            done.set()

    bus.subscribe("/ping", on_ping)
    done.wait(timeout=20.0)
    bus.close()


def fsm(parent_port, items, targets, dt):
    from alore_legged_manipulator_tpu_torch.mission.object_fsm import FsmState
    from alore_legged_manipulator_tpu_torch.runtime.bus_mission import (
        MissionFsmNode)
    bus = UdpBus(peers=[("127.0.0.1", parent_port)])
    print(bus.address[1], flush=True)
    node = MissionFsmNode(bus, items, targets,
                          order=list(range(len(items))), dt=dt)
    t0 = time.time()
    while time.time() - t0 < 60.0:
        node.tick()          # consumes the latest /env_obs datagram
        if node.fsm.state == FsmState.DONE:
            print("DONE", flush=True)
            break
        time.sleep(0.001)
    bus.close()


if __name__ == "__main__":
    role, port = sys.argv[1], int(sys.argv[2])
    if role == "echo":
        echo(port, int(sys.argv[3]), native=sys.argv[4:5] == ["native"])
    else:
        fsm(port, json.loads(sys.argv[3]), json.loads(sys.argv[4]),
            float(sys.argv[5]))
