"""Wireless remote-controller channel: decode, gating, teleop mapping.

The reference's deployment runtime is gated by the Unitree handheld
remote (Deployment/B2_deploy/common/remote_controller.py + the state
sequencing in deploy_real_b2z1_obj.py:606-620): the operator presses
`start` to leave zero-torque, `A` to arm the policy after the robot
reaches its default pose, and `select` to stop; in manual mode the
joysticks map to a base-velocity command (deploy_real:382-384
`cmd = [ly/2, -lx/2, -rx/2]`).

This module implements the same channel for the port's runtime (a
copy of the JAX package's `runtime/remote.py`, host numpy only):

  * the 24-byte-prefix wireless_remote frame layout (a hardware wire
    format: key bitfield at bytes 2-4, f32 axes lx/rx/ry at 4-16 and
    ly at 20-24) with both decode AND encode (the encoder synthesizes
    frames for sim/tests -- the real robot's radio fills the same
    bytes);
  * `RemoteGate`, the operator-sequencing state machine the deploy
    controller consults.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

FRAME_SIZE = 40      # unitree wireless_remote buffer length


class KeyMap:
    R1 = 0
    L1 = 1
    start = 2
    select = 3
    R2 = 4
    L2 = 5
    F1 = 6
    F2 = 7
    A = 8
    B = 9
    X = 10
    Y = 11
    up = 12
    right = 13
    down = 14
    left = 15


@dataclass
class RemoteState:
    lx: float = 0.0
    ly: float = 0.0
    rx: float = 0.0
    ry: float = 0.0
    button: list = field(default_factory=lambda: [0] * 16)

    def set(self, data: bytes):
        """Decode one wireless_remote frame (remote_controller.py:30-38)."""
        keys = struct.unpack("H", bytes(data[2:4]))[0]
        for i in range(16):
            self.button[i] = (keys >> i) & 1
        self.lx = struct.unpack("f", bytes(data[4:8]))[0]
        self.rx = struct.unpack("f", bytes(data[8:12]))[0]
        self.ry = struct.unpack("f", bytes(data[12:16]))[0]
        self.ly = struct.unpack("f", bytes(data[20:24]))[0]


def pack_remote(lx=0.0, rx=0.0, ry=0.0, ly=0.0, buttons=()) -> bytes:
    """Synthesize a wireless_remote frame (the radio's role in sim)."""
    keys = 0
    for b in buttons:
        keys |= 1 << int(b)
    frame = bytearray(FRAME_SIZE)
    frame[2:4] = struct.pack("H", keys)
    frame[4:8] = struct.pack("f", lx)
    frame[8:12] = struct.pack("f", rx)
    frame[12:16] = struct.pack("f", ry)
    frame[20:24] = struct.pack("f", ly)
    return bytes(frame)


class GatePhase:
    WAIT_START = 0     # zero torque until `start`
    RAMPING = 1        # move-to-default in progress
    WAIT_A = 2         # holding default until `A`
    ARMED = 3          # policy running
    STOPPED = 4        # `select` pressed -> damped stop


@dataclass
class RemoteGate:
    """Operator sequencing: start -> (ramp) -> A -> policy; select stops.

    Mirrors deploy_real_b2z1_obj.py's zero_torque_state (:266-268,
    waits for start), default_pos_state (:306-310, waits for A), and the
    teleop joystick mapping (:382-384).
    """

    state: RemoteState = field(default_factory=RemoteState)
    phase: int = GatePhase.WAIT_START

    def feed(self, frame: bytes):
        self.state.set(frame)
        b = self.state.button
        if b[KeyMap.select]:
            self.phase = GatePhase.STOPPED
            return
        if self.phase == GatePhase.WAIT_START and b[KeyMap.start]:
            self.phase = GatePhase.RAMPING
        elif self.phase == GatePhase.WAIT_A and b[KeyMap.A]:
            self.phase = GatePhase.ARMED

    def ramp_done(self):
        if self.phase == GatePhase.RAMPING:
            self.phase = GatePhase.WAIT_A

    def teleop_cmd(self) -> np.ndarray:
        """Joystick base-velocity command (deploy_real:382-384)."""
        s = self.state
        return np.array([s.ly / 2.0, -s.lx / 2.0, -s.rx / 2.0])
