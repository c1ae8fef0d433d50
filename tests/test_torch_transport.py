"""Port parity: the UDP transport (`runtime/transport.py`) and its native
datapath (`native/bus.cpp`, `runtime/native_transport.py`).

* `bus.cpp` is the JAX package's byte for byte and builds into
  `build/bus-<hash>/`; without g++ `load_bus` raises (no fallback);
* `_encode` gives the JAX package's bytes for every payload of
  tests/test_transport.py and its dtype matrix, and `_decode` reads them;
* the port's `UdpBus` and the JAX package's exchange contract messages
  both ways; native <-> Python both ways; KEEP_LAST(1) from the C++
  store; the dtype matrix over the native bus; non-array payloads stay
  in-process;
* real processes (tests/torch_bus_worker.py, port only): an echo node on
  either bus, and tests/test_cross_process_mission.py's two-process
  mission (perception + oracle controller here, the mission FSM in the
  child, nothing shared but datagrams).
"""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from alore_legged_manipulator_tpu.runtime import transport as jt
from alore_legged_manipulator_tpu_torch import native as tnative
from alore_legged_manipulator_tpu_torch.runtime import transport as tt
from alore_legged_manipulator_tpu_torch.runtime.contracts import (CarState,
                                                                  EnvObs)
from alore_legged_manipulator_tpu_torch.runtime.native_transport import (
    NativeUdpBus)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_bus_worker.py")
PAYLOADS = [np.zeros(3, np.float32),
            np.arange(24, dtype=np.float64).reshape(2, 3, 4),
            np.array(7, np.int32),
            np.random.default_rng(0).normal(size=(10, 33)).astype(np.float32),
            np.array([True, False]),
            np.arange(10, dtype=np.uint8),
            np.arange(6, dtype=np.int64)]


def _wait_for(pred, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_bus_source_is_the_jax_packages_and_builds():
    with open(os.path.join(REPO, "alore_legged_manipulator_tpu", "native",
                           "bus.cpp"), "rb") as f:
        assert tnative.BUS_SRC.read_bytes() == f.read()
    so = tnative.build(tnative.BUS_SRC, tnative.BUS_FLAGS, "libalorebus.so")
    assert so.parent.parent.name == "build"
    assert so.parent.name.startswith("bus-")
    assert tnative.load_bus() is tnative.load_bus()


def test_load_bus_raises_without_gxx(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_BUS_LIB", None)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        NativeUdpBus()


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_encode_bytes_equal_jax(i):
    arr = PAYLOADS[i]
    data = tt._encode("/some/topic", arr)
    assert data == jt._encode("/some/topic", arr)
    topic, out = tt._decode(data)
    assert topic == "/some/topic"
    assert out.dtype == arr.dtype and out.shape == arr.shape
    np.testing.assert_array_equal(out, arr)
    with pytest.raises(ValueError, match="datagram"):
        tt._encode("/big", np.zeros(20000, np.float32))


def test_port_and_jax_buses_interoperate():
    with tt.UdpBus() as port, jt.UdpBus() as ref:
        port.add_peer("127.0.0.1", ref.address[1])
        ref.add_peer("127.0.0.1", port.address[1])
        got_ref, got_port = [], []
        ref.subscribe("/carstate", got_ref.append)
        port.subscribe("/env_obs", got_port.append)
        port.publish("/carstate",
                     CarState(x=1.5, y=-2.0, yaw=0.7, v=1.1,
                              omega=-0.2).pack())
        obs = EnvObs()
        obs.robot.xyz[:] = [1.0, 2.0, 0.0]
        obs.robot.yaw = 0.5
        ref.publish("/env_obs", obs.pack())
        assert _wait_for(lambda: got_ref and got_port)
        back = CarState.unpack(got_ref[0])
        assert abs(back.x - 1.5) < 1e-6 and abs(back.omega + 0.2) < 1e-6
        back = EnvObs.unpack(got_port[0])
        np.testing.assert_allclose(back.robot.xyz, [1, 2, 0])
        np.testing.assert_array_equal(port.latest("/env_obs"), obs.pack())


def test_native_python_interop():
    with NativeUdpBus() as nat, tt.UdpBus() as py:
        nat.add_peer("127.0.0.1", py.address[1])
        py.add_peer("127.0.0.1", nat.address[1])
        got_py, got_nat = [], []
        py.subscribe("/n2p", lambda m: got_py.append(np.asarray(m)))
        nat.subscribe("/p2n", lambda m: got_nat.append(np.asarray(m)))
        m1 = PAYLOADS[3]
        nat.publish("/n2p", m1)
        py.publish("/p2n", PAYLOADS[6])
        assert _wait_for(lambda: got_py and got_nat)
        np.testing.assert_array_equal(got_py[0], m1)
        assert got_py[0].dtype == np.float32
        np.testing.assert_array_equal(got_nat[0], PAYLOADS[6])
        assert got_nat[0].dtype == np.int64


def test_keep_last_semantics():
    with NativeUdpBus() as a, NativeUdpBus() as b:
        a.add_peer("127.0.0.1", b.address[1])
        a.publish("/s", np.float32(1.0))
        a.publish("/s", np.float32(2.0))
        assert _wait_for(lambda: b.latest("/s") is not None
                         and float(np.asarray(b.latest("/s"))) == 2.0)
        nl = b.native_latest("/s")
        assert nl is not None and float(nl) == 2.0
        assert b.native_latest("/never") is None


def test_dtype_matrix_and_local_delivery():
    with NativeUdpBus() as a:
        got = []
        a.subscribe("/local", got.append)
        a.publish("/local", np.ones(4))
        assert len(got) == 1            # synchronous local dispatch
    with NativeUdpBus() as a, NativeUdpBus() as b:
        a.add_peer("127.0.0.1", b.address[1])
        for arr in PAYLOADS:
            topic = f"/t/{arr.dtype.char}/{arr.ndim}/{arr.size}"
            a.publish(topic, arr)
            assert _wait_for(lambda: b.latest(topic) is not None)
            out = np.asarray(b.latest(topic))
            assert out.dtype == arr.dtype and out.shape == arr.shape
            np.testing.assert_array_equal(out, arr)
        assert b.dropped() == 0


def test_non_array_payload_stays_in_process():
    for Bus in (tt.UdpBus, NativeUdpBus):
        with Bus() as a, Bus() as b:
            a.add_peer("127.0.0.1", b.address[1])
            local = []
            a.subscribe("/obj", local.append)
            a.publish("/obj", {"not": "an array"})
            assert local == [{"not": "an array"}]


def _child(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    return subprocess.Popen([sys.executable, WORKER, *map(str, args)],
                            stdout=subprocess.PIPE, text=True, env=env)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_cross_process_echo(native):
    with tt.UdpBus() as bus:
        pongs = []
        bus.subscribe("/pong", pongs.append)
        proc = _child("echo", bus.address[1], 3,
                      *(["native"] if native else []))
        try:
            bus.add_peer("127.0.0.1", int(proc.stdout.readline().strip()))
            for i in range(3):
                payload = np.full(18, float(i), np.float32)
                bus.publish("/ping", payload)
                assert _wait_for(lambda: len(pongs) >= i + 1, timeout=10.0)
                np.testing.assert_allclose(pongs[i], payload + 1.0)
            proc.wait(timeout=20.0)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_two_process_mission_over_udp():
    from alore_legged_manipulator_tpu_torch.runtime.bus_mission import (
        PerceptionNode, WorldState)
    from alore_legged_manipulator_tpu_torch.runtime.highlevel_controller import (  # noqa: E501
        HighLevelControllerNode, make_oracle_policy)
    dt = 0.05
    items = [[1.2, 0.3, 0.0]]
    targets = [[2.4, 1.2, 0.0]]
    world = WorldState(robot=np.zeros(3),
                       objects=[np.asarray(items[0], float).copy()]
                       + [np.zeros(3) for _ in range(3)])
    with tt.UdpBus() as bus:
        percept = PerceptionNode(bus, seed=2)
        ctrl = HighLevelControllerNode(bus, world, make_oracle_policy(),
                                       device="cpu")
        proc = _child("fsm", bus.address[1], json.dumps(items),
                      json.dumps(targets), dt)
        try:
            bus.add_peer("127.0.0.1", int(proc.stdout.readline().strip()))
            t0 = time.time()
            done = False
            while time.time() - t0 < 90.0:
                percept.tick(world)
                ctrl.tick(dt=dt)
                if proc.poll() is not None:
                    done = True
                    break
                time.sleep(0.001)
            assert done, f"child FSM did not finish; object at " \
                f"{world.objects[0]}"
            assert "DONE" in proc.stdout.read()
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    err = np.linalg.norm(world.objects[0][:2] - np.asarray(targets[0])[:2])
    assert err < 0.5, (err, world.objects[0])
