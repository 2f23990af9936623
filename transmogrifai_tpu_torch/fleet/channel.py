"""Bounded request/response transport between router and replicas.

The transport tier of the scale-out serving fleet (reference frame:
the TensorFlow system paper's position that throughput
scaling comes from many coordinated workers behind one dispatch layer,
arXiv 1605.08695 §3 - the dataflow workers there talk over explicit
Send/Recv edges, and this module is that edge for serving): one stream
socket per replica - AF_UNIX for on-host replicas (the fast path), TCP
for cross-host ones - carrying length-framed messages, with a wire
format deliberately split into a tiny header/meta part and an OPAQUE
payload:

* the router never (un)pickles record batches - it forwards the
  caller's encoded payload bytes verbatim and hands responses back with
  the result payload still encoded (decoded lazily by the caller), so
  the dispatch layer's per-row cost is framing + syscalls, not object
  graph serialization.  That is what keeps one router process able to
  feed 4+ replicas at aggregate rates a single GIL could never pickle;
* encode-once/retry-many: a batch is encoded at submission and the
  SAME bytes are re-sent when a dead or ejected replica's in-flight
  requests are retried on survivors (at-least-once delivery with
  idempotent scoring - the fleet may score a row twice, the caller
  sees it once);
* every blocking wait is bounded at ``QUANTUM_S`` (50 ms) quanta - the
  pipeline discipline, style-gated for fleet/ in
  tests/test_torch_style.py: sockets run under ``settimeout(QUANTUM_S)`` and
  every send/recv loop re-checks its stop flag/deadline per quantum, so
  a wedged or vanished peer can never block the router or a worker
  forever (a SIGKILLed peer closes the socket -> ``ChannelClosedError``
  immediately);
* every frame carries a CRC32 of its body.  A unix socket cannot
  corrupt bytes, but a TCP path crossing NICs/middleboxes can (and
  TCP's own 16-bit checksum provably lets corruption through at scale),
  so a mismatch raises :class:`ChannelProtocolError` - counted on the
  channel, surfaced in the router's view, and NEVER decoded into a
  garbage batch.  A corrupt stream is unsyncable, so the channel closes
  and the health machinery reconnects.

Addressing: ``host:port`` / ``tcp://host:port`` selects TCP (keepalive
tuned so a silently-dead cross-host peer is detected in seconds, Nagle
off so small frames are not delayed behind a timer); anything else is
an AF_UNIX socket path.  TCP connections complete an ``OP_HELLO``
handshake (magic + peer identity, bounded by its own timeout) before
the channel is handed to the router - a cross-wired port or a foreign
listener fails loudly at connect, not as garbage frames mid-serve.

Deterministic network-fault seams (driven by the TX_FAULTS framework,
see faults/injection.py; ``delay=`` is the impairment duration):

* ``fleet.partition``      - on a data send, the channel drops BOTH
  directions for ``delay`` seconds: outbound frames vanish, inbound
  bytes queue unread in the kernel until the window heals;
* ``fleet.half_open``      - outbound frames vanish for ``delay``
  seconds but the channel keeps reading: the peer that accepts work
  and never responds, the drill a unix socketpair cannot express;
* ``channel.corrupt_frame``- the frame goes out with a flipped CRC, so
  the receiver proves the integrity check end to end;
* ``fleet.reconnect_storm``- :func:`connect` drops the connection
  before the handshake, drilling rate-bounded reconnect probes.

Fault *consumption* happens only on data sends (and connects) - never
on recv polls - so ``on=N``/``every=N`` trigger counts are a
deterministic function of traffic, not of idle-poll timing.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
import zlib
from typing import Any, Optional, Sequence, Tuple

from ..faults import injection as _faults
from ..parallel.kernels import is_device_fault

#: the bounded-wait quantum every blocking socket operation runs under
QUANTUM_S = 0.05

#: message ops (u8 on the wire)
OP_SCORE = 1
OP_RESULT = 2
OP_ERROR = 3
OP_CONTROL = 4
OP_CONTROL_RESULT = 5
OP_HELLO = 6

#: frame = u64 body length + u32 CRC32(body); body = u8 op, u64 req_id,
#: u32 meta_len, meta bytes (pickled small dict), payload (the rest,
#: opaque)
_FRAME = struct.Struct("<QI")
_HEADER = struct.Struct("<BQI")

#: a frame larger than this is a protocol error, not a request (guards
#: the length-prefix read against garbage bytes from a foreign writer)
MAX_FRAME_BYTES = 1 << 31

#: handshake identity: both ends must present this or the connection is
#: cross-wired (wrong port, foreign service) and fails at connect
WIRE_MAGIC = "txfleet2"

#: default bound on the OP_HELLO round trip at connect
HANDSHAKE_TIMEOUT_S = 5.0

#: impairment window when an armed partition/half_open spec has no
#: ``delay=`` field
DEFAULT_IMPAIR_S = 1.0

#: TCP keepalive: first probe after 5 s idle, then every 2 s, dead
#: after 3 missed - a silently-vanished cross-host peer (power loss,
#: cable pull: no FIN, no RST) surfaces as ChannelClosedError in ~11 s
#: instead of the kernel default's ~2 h
_TCP_KEEPALIVE = (("TCP_KEEPIDLE", 5), ("TCP_KEEPINTVL", 2),
                  ("TCP_KEEPCNT", 3))


class ChannelClosedError(RuntimeError):
    """The peer closed (or was SIGKILLed out from under) the socket."""


class ChannelTimeoutError(TimeoutError):
    """A bounded channel operation ran past its deadline."""


class ChannelProtocolError(RuntimeError):
    """The stream carried bytes that are not a valid frame (CRC
    mismatch, oversized length prefix, undecodable meta, bad
    handshake).  The channel is unsyncable past this point and closes;
    the erroring frame is counted, never decoded into a batch."""


def parse_address(address: str) -> Tuple[str, Any]:
    """``address`` -> ``("tcp", (host, port))`` or ``("unix", path)``.

    ``tcp://host:port`` is explicit; a bare ``host:port`` whose port
    parses as an integer and which contains no path separator is
    inferred as TCP; everything else is an AF_UNIX socket path.
    """
    if address.startswith("tcp://"):
        host, _, port = address[len("tcp://"):].rpartition(":")
        return "tcp", (host or "127.0.0.1", int(port))
    host, sep, port = address.rpartition(":")
    if sep and host and os.sep not in address and port.isdigit():
        return "tcp", (host, int(port))
    return "unix", address


def _tune_tcp(sock: socket.socket) -> None:
    """Latency + liveness tuning for TCP channels: Nagle off (length-
    framed request/response must not wait on a coalescing timer) and
    aggressive keepalive (see :data:`_TCP_KEEPALIVE`)."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        for name, val in _TCP_KEEPALIVE:
            if hasattr(socket, name):
                sock.setsockopt(socket.IPPROTO_TCP,
                                getattr(socket, name), val)
    except OSError:
        pass  # tuning is best-effort; an untuned channel still works


def encode_records(records: Sequence[Any]) -> bytes:
    """Record batch -> opaque payload bytes (the caller-side half of
    the encode-once contract; a retried request reuses these bytes)."""
    return pickle.dumps(list(records), protocol=5)


def decode_records(payload: bytes) -> list:
    return pickle.loads(payload)


def encode_results(results: Sequence[Any]) -> bytes:
    """Score results -> opaque payload bytes (worker side; the router
    relays them undecoded and the caller decodes lazily)."""
    return pickle.dumps(list(results), protocol=5)


def decode_results(payload: bytes) -> list:
    return pickle.loads(payload)


class FleetChannel:
    """Length-framed, CRC-checked messages over one connected stream
    socket (AF_UNIX or TCP) with every blocking primitive bounded at
    :data:`QUANTUM_S` quanta.

    Thread contract: any number of threads may :meth:`send` (a lock
    serializes frames); exactly ONE thread may :meth:`recv` (the
    router's per-replica receiver thread / the worker's serve loop).
    """

    #: socket buffer request: large enough that a whole wire batch
    #: lands in one or two kernel chunks - the receiver then wakes
    #: once or twice per message instead of once per 64 KB default
    #: buffer (the wakeup churn, not the memcpy, dominates the
    #: router's per-row CPU; the kernel clamps this to wmem_max)
    SOCK_BUF_BYTES = 4 << 20

    def __init__(self, sock: socket.socket) -> None:
        sock.settimeout(QUANTUM_S)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                            self.SOCK_BUF_BYTES)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                            self.SOCK_BUF_BYTES)
        except OSError:
            pass  # clamped/refused: the default buffer still works
        if sock.family in (socket.AF_INET, socket.AF_INET6):
            _tune_tcp(sock)
        self._sock = sock
        self._send_lock = threading.Lock()
        self.closed = False
        #: handshake meta from the peer (set by connect(); workers
        #: leave it None - they learn the router exists by serving it)
        self.peer: Optional[dict] = None
        # -- injected-impairment window (fault drills) --
        self._impair_mode: Optional[str] = None
        self._impair_until = 0.0
        # -- integrity/fault counters (read by router + worker obs) --
        self.protocol_errors = 0   # CRC/length/meta violations seen
        self.frames_dropped = 0    # outbound frames eaten by a window
        self.partitions = 0        # partition windows opened
        self.half_opens = 0        # half-open windows opened
        self.corrupt_injected = 0  # frames sent with a flipped CRC

    def stats(self) -> dict:
        """Integrity/fault counters as one plain dict (obs plane)."""
        return {
            "protocol_errors": self.protocol_errors,
            "frames_dropped": self.frames_dropped,
            "partitions": self.partitions,
            "half_opens": self.half_opens,
            "corrupt_injected": self.corrupt_injected,
        }

    # -- injected impairment ------------------------------------------------
    def _impairment(self) -> Optional[str]:
        """The currently-open impairment window's mode, or None.  Never
        consumes fault-trigger calls (recv polls must not burn
        ``on=N`` counts)."""
        if self._impair_mode is not None:
            if time.monotonic() < self._impair_until:
                return self._impair_mode
            self._impair_mode = None
        return None

    def _maybe_open_impairment(self) -> Optional[str]:
        """Called once per DATA send: extend/open a partition or
        half-open window from the fault plan.  Returns the active
        mode, or None for a healthy channel."""
        mode = self._impairment()
        if mode is not None:
            return mode
        for point, mode in (("fleet.partition", "partition"),
                            ("fleet.half_open", "half_open")):
            spec = _faults.fires(point)
            if spec is not None:
                self._impair_mode = mode
                self._impair_until = (time.monotonic()
                                      + (spec.delay or DEFAULT_IMPAIR_S))
                if mode == "partition":
                    self.partitions += 1
                else:
                    self.half_opens += 1
                return mode
        return None

    # -- low-level bounded IO -----------------------------------------------
    def _send_all(self, data, deadline: Optional[float],
                  stop: Optional[threading.Event]) -> None:
        view = memoryview(data)
        off = 0
        while off < len(view):
            if stop is not None and stop.is_set():
                raise ChannelClosedError("channel stopping")
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError("send deadline exceeded")
            try:
                off += self._sock.send(view[off:])
            except socket.timeout:
                continue
            except OSError as e:
                self.closed = True
                raise ChannelClosedError(f"peer gone mid-send: {e}") from e

    def send(self, op: int, req_id: int, meta: dict,
             payload=b"", timeout_s: Optional[float] = None,
             stop: Optional[threading.Event] = None) -> None:
        """Send one framed message.  Head+meta and the payload go out
        in ONE ``sendmsg`` gather call when possible - no
        concatenation copy of a potentially-large batch and one fewer
        syscall per message (the router's per-row cost is syscalls +
        kernel copies)."""
        meta_b = pickle.dumps(meta, protocol=5)
        body_len = _HEADER.size + len(meta_b) + len(payload)
        head_body = _HEADER.pack(op, req_id, len(meta_b)) + meta_b
        crc = zlib.crc32(head_body)
        if payload:
            crc = zlib.crc32(payload, crc)
        if op != OP_HELLO and _faults.active():
            # the network-fault seam: handshakes are connection
            # establishment, not the drill surface, so only data
            # frames open/extend impairment windows or get corrupted
            if self._maybe_open_impairment() is not None:
                self.frames_dropped += 1
                return  # the frame vanishes into the partition
            if _faults.fires("channel.corrupt_frame") is not None:
                crc ^= 0x5A5A5A5A
                self.corrupt_injected += 1
        head = _FRAME.pack(body_len, crc) + head_body
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._send_lock:
            if payload:
                try:
                    sent = self._sock.sendmsg([head, payload])
                except socket.timeout:
                    sent = 0
                except OSError as e:
                    self.closed = True
                    raise ChannelClosedError(
                        f"peer gone mid-send: {e}") from e
                if sent >= len(head) + len(payload):
                    return
                # partial gather write (full socket buffer): finish
                # byte-exactly with the bounded loop
                if sent < len(head):
                    self._send_all(memoryview(head)[sent:], deadline,
                                   stop)
                    self._send_all(payload, deadline, stop)
                else:
                    self._send_all(
                        memoryview(payload)[sent - len(head):],
                        deadline, stop)
            else:
                self._send_all(head, deadline, stop)

    def _recv_exact(self, n: int, stop: Optional[threading.Event],
                    idle_return: bool) -> Optional[bytearray]:
        """Read exactly ``n`` bytes into ONE preallocated buffer via
        ``recv_into`` - the payload never makes an extra userspace copy
        (the router's per-row cost is this loop).  Returns None when
        ``idle_return`` and a quantum passed with nothing read yet;
        once bytes have arrived it keeps reading - a live peer
        mid-frame finishes, a dead one raises."""
        buf = bytearray(n)
        view = memoryview(buf)
        off = 0
        while off < n:
            if stop is not None and stop.is_set():
                return None
            try:
                k = self._sock.recv_into(view[off:], n - off)
            except socket.timeout:
                if idle_return and off == 0:
                    return None
                continue
            except OSError as e:
                self.closed = True
                raise ChannelClosedError(f"peer gone mid-recv: {e}") from e
            if k == 0:
                self.closed = True
                raise ChannelClosedError("peer closed the channel")
            off += k
        return buf

    def recv(self, stop: Optional[threading.Event] = None,
             idle_return: bool = True) -> Optional[tuple]:
        """One message as ``(op, req_id, meta, payload)``, or ``None``
        when idle for a quantum (``idle_return``) or ``stop`` is set.
        The payload comes back as a memoryview over the single receive
        buffer (``decode_records``/``decode_results`` consume it
        directly; ``send`` re-sends it on failover without a copy).
        Raises :class:`ChannelClosedError` on peer death/EOF and
        :class:`ChannelProtocolError` on a corrupt frame (the stream
        is unsyncable past it; the channel is closed)."""
        if self._impairment() == "partition":
            # both directions dead: leave inbound bytes queued in the
            # kernel until the window heals (exactly what a network
            # partition does to data in flight)
            time.sleep(QUANTUM_S)
            return None
        head = self._recv_exact(_FRAME.size, stop, idle_return)
        if head is None:
            return None
        body_len, crc_expected = _FRAME.unpack_from(head)
        if body_len > MAX_FRAME_BYTES:
            self.protocol_errors += 1
            self.closed = True
            raise ChannelProtocolError(
                f"oversized frame ({body_len} bytes): protocol corruption"
            )
        body = self._recv_exact(body_len, stop, idle_return=False)
        if body is None:
            return None
        if zlib.crc32(body) != crc_expected:
            self.protocol_errors += 1
            self.closed = True
            raise ChannelProtocolError(
                f"frame CRC mismatch ({body_len}-byte body): corrupt "
                "stream, closing channel"
            )
        op, req_id, meta_len = _HEADER.unpack_from(body)
        meta_off = _HEADER.size
        try:
            meta = pickle.loads(
                memoryview(body)[meta_off:meta_off + meta_len])
        except Exception as e:
            if is_device_fault(e):
                raise
            self.protocol_errors += 1
            self.closed = True
            raise ChannelProtocolError(
                f"undecodable frame meta (op={op}): {e}") from e
        payload = memoryview(body)[meta_off + meta_len:body_len]
        return op, req_id, meta, payload

    # -- handshake ----------------------------------------------------------
    def handshake_client(self, timeout_s: float = HANDSHAKE_TIMEOUT_S,
                         stop: Optional[threading.Event] = None) -> dict:
        """Send OP_HELLO and wait (bounded) for the peer's OP_HELLO
        reply; returns the peer's meta ({"magic", "instance", "pid"}).
        A wrong-magic peer or silence past ``timeout_s`` fails loudly
        here instead of as garbage frames mid-serve."""
        self.send(OP_HELLO, 0, {"magic": WIRE_MAGIC, "pid": os.getpid()},
                  timeout_s=timeout_s, stop=stop)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() <= deadline:
            if stop is not None and stop.is_set():
                raise ChannelClosedError("stopping mid-handshake")
            msg = self.recv(stop=stop)
            if msg is None:
                continue
            op, _rid, meta, _payload = msg
            if op != OP_HELLO or meta.get("magic") != WIRE_MAGIC:
                self.protocol_errors += 1
                self.closed = True
                raise ChannelProtocolError(
                    f"bad handshake reply (op={op}, "
                    f"magic={meta.get('magic')!r}): cross-wired peer"
                )
            self.peer = dict(meta)
            return self.peer
        raise ChannelTimeoutError(
            f"no handshake reply within {timeout_s}s")

    def hello_reply_meta(self) -> dict:
        """The server-side half of the handshake (the worker attaches
        its identity so the router can verify it reached the replica
        it meant to)."""
        return {"magic": WIRE_MAGIC, "pid": os.getpid()}

    def close(self) -> None:
        self.closed = True
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# connection establishment (both bounded)
# ---------------------------------------------------------------------------
def listen(address: str) -> socket.socket:
    """Bind + listen a worker's socket - AF_UNIX path (stale file
    replaced) or ``host:port`` TCP; the returned listener runs under
    the bounded-accept quantum."""
    scheme, target = parse_address(address)
    if scheme == "tcp":
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lsock.bind(target)
    else:
        try:
            os.unlink(target)
        except OSError:
            pass  # first bind: nothing stale to replace
        lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        lsock.bind(target)
    # backlog 2: the controller's restart reconnect and the router's
    # readmission probe may race to the same worker; neither should
    # see a refused connect
    lsock.listen(2)
    lsock.settimeout(QUANTUM_S)
    return lsock


def accept(lsock: socket.socket, timeout_s: float,
           stop: Optional[threading.Event] = None
           ) -> Optional[FleetChannel]:
    """Accept one peer within ``timeout_s`` (quantum-bounded); None on
    deadline/stop.  At least one accept attempt is always made, so
    ``timeout_s=0.0`` is a single bounded poll (the worker's
    newest-connection-wins idle check)."""
    deadline = time.monotonic() + timeout_s
    while True:
        if stop is not None and stop.is_set():
            return None
        try:
            sock, _ = lsock.accept()
        except socket.timeout:
            if time.monotonic() > deadline:
                return None
            continue
        except OSError as e:
            raise ChannelClosedError(f"listener closed: {e}") from e
        return FleetChannel(sock)


def connect(address: str, timeout_s: float = 30.0,
            handshake: bool = True,
            handshake_timeout_s: float = HANDSHAKE_TIMEOUT_S
            ) -> FleetChannel:
    """Connect to a worker's socket (AF_UNIX path or ``host:port``
    TCP), retrying per quantum until the worker has bound it (startup
    race) or the deadline passes, then complete the bounded OP_HELLO
    handshake (the worker replies from its serve loop, so a returned
    channel is one a live replica is actually serving)."""
    scheme, target = parse_address(address)
    family = socket.AF_INET if scheme == "tcp" else socket.AF_UNIX
    deadline = time.monotonic() + timeout_s
    while True:
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.settimeout(QUANTUM_S)
        try:
            sock.connect(target)
        except (FileNotFoundError, ConnectionRefusedError, socket.timeout,
                OSError):
            sock.close()
            if time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    f"no worker listening at {address} within "
                    f"{timeout_s}s"
                ) from None
            time.sleep(QUANTUM_S)
            continue
        if _faults.fires("fleet.reconnect_storm") is not None:
            sock.close()
            raise ChannelProtocolError(
                f"injected reconnect storm: connection to {address} "
                "dropped before handshake")
        chan = FleetChannel(sock)
        if not handshake:
            return chan
        try:
            chan.handshake_client(handshake_timeout_s)
            return chan
        except ChannelProtocolError:
            chan.close()
            raise  # wrong magic / bad frame: permanent, never retried
        except (ChannelClosedError, ChannelTimeoutError):
            # the worker accepted but is busy serving another channel
            # (its newest-connection-wins accept loop will pick us up
            # on its next idle poll - or a restart race closed us):
            # retry a FRESH connection until the overall deadline
            chan.close()
            if time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    f"worker at {address} accepted but did not complete "
                    f"the handshake within {timeout_s}s"
                ) from None
            time.sleep(QUANTUM_S)
