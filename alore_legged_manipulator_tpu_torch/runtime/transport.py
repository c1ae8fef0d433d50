"""UDP pub/sub transport: the DDS seam of the deployment runtime (the
port's own copy of runtime/transport.py, over the port's MessageBus).

The reference's robot side runs on Unitree's DDS stack -- LowCmd/LowState
publishers and subscribers created over a channel factory
(Deployment/B2_deploy/deploy_real_b2z1_obj.py:61-81 ChannelPublisher/
ChannelSubscriber; the vendored unitree_sdk2_python provides the
transport).  DDS itself is a vendored external dependency there; what the
framework owes is the SEAM: a transport with DDS semantics (topic-keyed,
best-effort, latest-value, cross-process) that the in-process MessageBus
abstraction can be swapped for without touching any node code.

`UdpBus` is that seam: it subclasses `MessageBus` so every runtime node
(deploy controller, perception, mission FSM, Z1 arm) runs over it
unchanged, while datagrams carry the packed float32 contract arrays
(runtime/contracts.py) between processes.  Semantics match DDS
best-effort pub/sub:

  * publish = local dispatch + one datagram per peer (fire-and-forget,
    no delivery guarantee -- like BEST_EFFORT QoS);
  * subscribe callbacks fire on the receive thread; `latest()` keeps
    KEEP_LAST(1) history;
  * topics are strings; payloads are numpy arrays (any dtype/shape) or
    tensors on the CPU -- every runtime contract packs to one.

Wire format (one datagram per message, little-endian):
  magic  u16  = 0xA10E
  tlen   u16  topic byte length
  ndim   u8   payload rank
  dtype  u8   numpy type char (ASCII)
  shape  u32 x ndim
  topic  bytes[tlen]
  data   raw array bytes
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .deploy import MessageBus

_MAGIC = 0xA10E
_HDR = struct.Struct("<HHBB")
_MAX_DGRAM = 60000


def _encode(topic: str, msg) -> bytes:
    # NOT ascontiguousarray: it promotes 0-d arrays to 1-d, breaking
    # scalar round-trips; tobytes() below copies non-contiguous data anyway
    arr = np.asarray(msg)
    tb = topic.encode("utf-8")
    if arr.ndim > 255:
        raise ValueError("payload rank too large")
    head = _HDR.pack(_MAGIC, len(tb), arr.ndim, ord(arr.dtype.char))
    shape = struct.pack("<%dI" % arr.ndim, *arr.shape)
    out = head + shape + tb + arr.tobytes()
    if len(out) > _MAX_DGRAM:
        raise ValueError(
            f"message on {topic!r} is {len(out)} B; exceeds one datagram "
            f"({_MAX_DGRAM} B) -- chunking is out of scope for this seam")
    return out


def _decode(buf: bytes) -> Optional[Tuple[str, np.ndarray]]:
    if len(buf) < _HDR.size:
        return None
    magic, tlen, ndim, dchar = _HDR.unpack_from(buf, 0)
    if magic != _MAGIC:
        return None
    off = _HDR.size
    shape = struct.unpack_from("<%dI" % ndim, buf, off)
    off += 4 * ndim
    topic = buf[off:off + tlen].decode("utf-8")
    off += tlen
    arr = np.frombuffer(buf, dtype=np.dtype(chr(dchar)), offset=off)
    return topic, arr.reshape(shape).copy()


class UdpBus(MessageBus):
    """MessageBus over UDP datagrams (DDS best-effort stand-in).

    bind:  local (host, port); port 0 picks an ephemeral port
           (readable afterwards via `self.address`).
    peers: remote (host, port) endpoints every publish is sent to.
           Peers can also be added later with `add_peer` (e.g. after the
           other process reports its ephemeral port).
    """

    def __init__(self, bind: Tuple[str, int] = ("127.0.0.1", 0),
                 peers: Sequence[Tuple[str, int]] = ()):
        super().__init__()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(bind)
        self._sock.settimeout(0.2)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._peers: List[Tuple[str, int]] = [tuple(p) for p in peers]
        self._lock = threading.Lock()
        self._closed = False
        self._rx = threading.Thread(target=self._recv_loop, daemon=True)
        self._rx.start()

    def add_peer(self, host: str, port: int):
        with self._lock:
            self._peers.append((host, int(port)))

    def publish(self, topic: str, msg):
        # local delivery keeps in-process nodes working exactly as with
        # the plain MessageBus
        super().publish(topic, msg)
        try:
            data = _encode(topic, msg)
        except (ValueError, TypeError):
            return  # non-array payload: in-process only (e.g. JointCommand)
        with self._lock:
            peers = list(self._peers)
        for p in peers:
            try:
                self._sock.sendto(data, p)
            except OSError:
                pass  # best-effort

    def _recv_loop(self):
        while not self._closed:
            try:
                buf, _ = self._sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                return
            out = _decode(buf)
            if out is None:
                continue
            topic, arr = out
            # remote delivery: dispatch WITHOUT re-sending (no loops)
            MessageBus.publish(self, topic, arr)

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        self._rx.join(timeout=1.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
