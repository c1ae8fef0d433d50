"""Native-datapath UDP bus: the C++ transport behind the MessageBus API
(port of runtime/native_transport.py).

Same seam as `runtime/transport.py` (the DDS stand-in the deployment
nodes run over), but the datapath -- encode/decode, the socket hot path,
the KEEP_LAST(1) store and the bounded receive inbox -- is the C++ core
in `native/bus.cpp`, mirroring the reference runtime where transport is
the vendored native unitree_sdk2 DDS stack and Python only assembles
messages (Deployment/B2_deploy/deploy_real_b2z1_obj.py:61-81).

Wire format is identical to `UdpBus`, so native and pure-Python
processes interoperate datagram-for-datagram
(tests/test_torch_transport.py).  The library is built with g++ at
first use (`native.load_bus`); a failed build raises RuntimeError, with
no fallback to the Python `UdpBus`.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..native import load_bus
from .deploy import MessageBus

_DATA_CAP = 65536
_TOPIC_CAP = 512
_SHAPE_CAP = 32


class NativeUdpBus(MessageBus):
    """MessageBus over the native (C++) UDP transport core.

    Drop-in for `UdpBus`: same constructor shape, same semantics
    (best-effort pub/sub, callbacks on a receive thread, KEEP_LAST(1)
    `latest()`).  The receive thread here only *dispatches*: parsing and
    buffering happened in C++.
    """

    def __init__(self, bind: Tuple[str, int] = ("127.0.0.1", 0),
                 peers: Sequence[Tuple[str, int]] = ()):
        super().__init__()
        self._lib = load_bus()
        port_out = ctypes.c_int(0)
        self._h = self._lib.alore_bus_create(
            bind[0].encode(), int(bind[1]), ctypes.byref(port_out))
        if not self._h:
            raise OSError(f"native bus bind failed on {bind}")
        self.address: Tuple[str, int] = (bind[0], port_out.value)
        for hp in peers:
            self.add_peer(*hp)
        self._closed = False
        # per-thread scratch not needed: one drain thread owns these
        self._topic_buf = ctypes.create_string_buffer(_TOPIC_CAP)
        self._dtype_buf = ctypes.c_char(b"\0")
        self._ndim_buf = ctypes.c_int(0)
        self._shape_buf = (ctypes.c_uint32 * _SHAPE_CAP)()
        self._data_buf = ctypes.create_string_buffer(_DATA_CAP)
        self._rx = threading.Thread(target=self._drain_loop, daemon=True)
        self._rx.start()

    def add_peer(self, host: str, port: int):
        self._lib.alore_bus_add_peer(self._h, host.encode(), int(port))

    def publish(self, topic: str, msg):
        # local in-process delivery first, exactly like UdpBus
        super().publish(topic, msg)
        try:
            arr = np.asarray(msg)
            dchar = arr.dtype.char.encode()
        except (ValueError, TypeError):
            return  # non-array payload: in-process only
        if arr.dtype == object:
            return
        shape = (ctypes.c_uint32 * max(arr.ndim, 1))(*arr.shape)
        data = arr.tobytes()
        self._lib.alore_bus_publish(
            self._h, topic.encode(), dchar, arr.ndim, shape, data,
            len(data))

    def dropped(self) -> int:
        """Messages dropped from the native inbox (telemetry)."""
        return int(self._lib.alore_bus_dropped(self._h))

    def _drain_loop(self):
        while not self._closed:
            n = self._lib.alore_bus_poll(
                self._h, 200, self._topic_buf, _TOPIC_CAP,
                ctypes.byref(self._dtype_buf), ctypes.byref(self._ndim_buf),
                self._shape_buf, _SHAPE_CAP, self._data_buf, _DATA_CAP)
            if n < 0:
                continue
            topic = self._topic_buf.value.decode("utf-8")
            ndim = self._ndim_buf.value
            shape = tuple(self._shape_buf[i] for i in range(ndim))
            dtype = np.dtype(self._dtype_buf.value.decode())
            raw = ctypes.string_at(self._data_buf, n)
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
            MessageBus.publish(self, topic, arr)

    def native_latest(self, topic: str) -> Optional[np.ndarray]:
        """KEEP_LAST(1) read served straight from the C++ store (no
        Python-side dispatch involved) -- the DDS `Read()` analogue."""
        dt = ctypes.c_char(b"\0")
        nd = ctypes.c_int(0)
        shape = (ctypes.c_uint32 * _SHAPE_CAP)()
        data = ctypes.create_string_buffer(_DATA_CAP)
        n = self._lib.alore_bus_latest(
            self._h, topic.encode(), ctypes.byref(dt), ctypes.byref(nd),
            shape, _SHAPE_CAP, data, _DATA_CAP)
        if n < 0:
            return None
        arr = np.frombuffer(data.raw[:n], dtype=np.dtype(dt.value.decode()))
        return arr.reshape(tuple(shape[i] for i in range(nd.value))).copy()

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._rx.join(timeout=1.0)
        self._lib.alore_bus_close(self._h)
        self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
