"""The fleet's wire and its in-process pieces, port against reference.

``transmogrifai_tpu_torch.fleet`` is a host copy of the JAX package's
``fleet/``; this file holds the parts that need no replica process:

* the wire itself: for the same op, request id, meta and payload the
  port's ``FleetChannel`` frames are byte-equal to the reference's, a
  frame that one package writes decodes in the other over a socketpair,
  and ``encode_records``/``encode_results`` are byte-equal;
* the contracts of the JAX package's tests/test_fleet.py that run in one
  process: tenant quotas, the snapshot merge, the channel round trip
  (idle and peer death), no replicas fails loudly, and the router's
  observed-throughput estimate;
* the unit surface of its tests/test_fleet_faults.py: addressing, the
  TCP round trip with CRC corruption, the handshakes, the reconnect
  storm, the ReplicaHealth state machine, brownout, decode errors and
  ``obs.fleet.health_views``;
* the autoscaler's names, which are not ported, raise naming item 12.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
import zlib

import pytest

from torch_parity import PORT, REF, mod, tiny_pipeline

from transmogrifai_tpu_torch.faults import injection as _faults
from transmogrifai_tpu_torch.fleet import (
    BrownoutShedError,
    FleetDecodeError,
    FleetRouter,
    ReplicaHealth,
    encode_records,
    merge_serving_snapshots,
)
from transmogrifai_tpu_torch.fleet.channel import (
    OP_HELLO,
    OP_SCORE,
    WIRE_MAGIC,
    ChannelClosedError,
    ChannelProtocolError,
    ChannelTimeoutError,
    FleetChannel,
    accept,
    connect,
    listen,
    parse_address,
)
from transmogrifai_tpu_torch.fleet.router import FleetResult, ReplicaHandle
from transmogrifai_tpu_torch.serving import QueueFullError, TenantQuotaError
from transmogrifai_tpu_torch.serving.admission import AdmissionController


@pytest.fixture(autouse=True)
def _disarm_faults():
    """Every drill leaves both processes' fault plans empty."""
    yield
    _faults.reset()
    mod(REF, "faults.injection").reset()


# -- the wire against the reference ------------------------------------------

MESSAGES = [
    (OP_SCORE, 7, {"tenant": None, "n_rows": 8}, b"\x00\x01" * 300),
    (OP_HELLO, 0, {"magic": WIRE_MAGIC, "pid": 4242}, b""),
    (5, 2 ** 40 + 3, {"cmd": "deploy", "version": "v2", "model_id": "m",
                      "deadline_unix": 1.7e9, "nested": {"a": [1, 2.5]}},
     bytes(range(256)) * 3),
]


def _frames(pkg, msgs):
    """The raw bytes ``pkg``'s channel puts on a unix socket for
    ``msgs``."""
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    chan = mod(pkg, "fleet.channel").FleetChannel(a)
    for op, rid, meta, payload in msgs:
        chan.send(op, rid, meta, payload)
    chan.close()
    out = bytearray()
    b.settimeout(5.0)
    while True:
        chunk = b.recv(1 << 16)
        if not chunk:
            break
        out += chunk
    b.close()
    return bytes(out)


def test_channel_frames_byte_equal_to_reference():
    """The same messages framed by both packages' channels give the
    same bytes, and each frame's CRC32 covers its body."""
    got, want = _frames(PORT, MESSAGES), _frames(REF, MESSAGES)
    assert got == want and len(got) > 0
    port_ch, ref_ch = mod(PORT, "fleet.channel"), mod(REF, "fleet.channel")
    assert port_ch.WIRE_MAGIC == ref_ch.WIRE_MAGIC
    assert port_ch.QUANTUM_S == ref_ch.QUANTUM_S
    for name in ("OP_SCORE", "OP_RESULT", "OP_ERROR", "OP_CONTROL",
                 "OP_CONTROL_RESULT", "OP_HELLO"):
        assert getattr(port_ch, name) == getattr(ref_ch, name), name
    # the CRC flipped by the corrupt-frame seam is the only difference
    _faults.configure("channel.corrupt_frame:on=1")
    mod(REF, "faults.injection").configure("channel.corrupt_frame:on=1")
    assert _frames(PORT, MESSAGES[:1]) == _frames(REF, MESSAGES[:1]) \
        != _frames(PORT, MESSAGES[:1])


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference_to_port", "port_to_reference"])
def test_frames_decode_across_packages(writer, reader):
    """A frame one package writes decodes in the other over a unix
    socketpair: op, request id, meta and payload round-trip exactly."""
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    tx = mod(writer, "fleet.channel").FleetChannel(a)
    rx = mod(reader, "fleet.channel").FleetChannel(b)
    try:
        for op, rid, meta, payload in MESSAGES:
            tx.send(op, rid, meta, payload)
            got_op, got_rid, got_meta, got = rx.recv()
            assert (got_op, got_rid, got_meta) == (op, rid, meta)
            assert bytes(got) == payload
        tx.close()
        with pytest.raises(mod(reader, "fleet.channel").ChannelClosedError):
            rx.recv()
    finally:
        tx.close()
        rx.close()


def test_record_and_result_codecs_byte_equal_to_reference():
    _wf, _data, records, _name = tiny_pipeline(PORT, n=40)
    results = [{"pred": {"prediction": 1.0, "probability_1": 0.25 * i}}
               for i in range(17)] + [{"error": "bad row"}]
    for fn, arg in (("encode_records", records),
                    ("encode_results", results)):
        got = getattr(mod(PORT, "fleet.channel"), fn)(arg)
        want = getattr(mod(REF, "fleet.channel"), fn)(arg)
        assert got == want, fn
    dec = mod(PORT, "fleet.channel")
    assert dec.decode_records(
        mod(REF, "fleet.channel").encode_records(records)) == records
    assert dec.decode_results(
        mod(REF, "fleet.channel").encode_results(results)) == results


# -- tests/test_fleet.py: tenant quotas, merge, channel, router --------------

def test_tenant_quota_bounds_one_tenant_not_the_rest():
    ac = AdmissionController(max_queue=10, tenant_quota=0.3)
    assert ac.tenant_limit == 3
    for _ in range(3):
        ac.admit({"r": 1}, tenant="hog")
    with pytest.raises(TenantQuotaError) as ei:
        ac.admit({"r": 1}, tenant="hog")
    assert ei.value.tenant == "hog" and ei.value.limit == 3
    ac.admit({"r": 1}, tenant="polite")
    ac.admit({"r": 1})
    assert ac.tenants_held() == {"hog": 3, "polite": 1, None: 1}
    live, shed = ac.take(10)
    assert len(live) == 5 and not shed
    assert ac.tenants_held() == {}
    ac.admit({"r": 1}, tenant="hog")


def test_tenant_quota_is_off_by_default():
    ac = AdmissionController(max_queue=4)
    for _ in range(4):
        ac.admit({"r": 1}, tenant="only")
    assert ac.tenant_limit is None


def test_scheduler_counts_shed_quota_and_scrapes_it():
    from transmogrifai_tpu_torch.obs import (
        metrics_registry,
        prometheus_text_from_json,
    )
    from transmogrifai_tpu_torch.serving import (
        MicroBatchScheduler,
        ServingTelemetry,
        compile_endpoint,
    )
    from transmogrifai_tpu_torch.testkit.drills import tiny_drill_pipeline

    wf, _data, records, _pred = tiny_drill_pipeline(n=40, device="cpu")
    model = wf.train()
    telemetry = ServingTelemetry()
    endpoint = compile_endpoint(model, telemetry=telemetry,
                                batch_buckets=(1, 8, 32))
    with MicroBatchScheduler(endpoint, start=False, max_queue=10,
                             tenant_quota=0.2,
                             telemetry=telemetry) as sched:
        for _ in range(2):
            sched.submit(records[0], tenant="hog")
        with pytest.raises(TenantQuotaError):
            sched.submit(records[0], tenant="hog")
        sched.submit(records[0], tenant="other")
        sched.run_once()
    snap = telemetry.snapshot()
    assert snap["shed_quota"] == 1
    assert snap["rows_scored"] == 3
    text = prometheus_text_from_json(metrics_registry().to_json())
    assert "tx_serving_shed_quota" in text


def test_merge_serving_snapshots_equal_to_reference():
    a = {"rows_scored": 10, "rows_failed": 1,
         "breaker": {"opens": 1, "rows_nonfinite": 2},
         "latency_ms": {"p99": 5.0},
         "data_contract": {"drift_js_max": 0.1},
         "model_version": "v1", "generation": 1}
    b = {"rows_scored": 20, "rows_failed": 2,
         "breaker": {"opens": 0, "rows_nonfinite": 1},
         "latency_ms": {"p99": 9.0},
         "data_contract": {"drift_js_max": 0.05}}
    merged = merge_serving_snapshots([a, b])
    assert merged["rows_scored"] == 30
    assert merged["rows_failed"] == 3
    assert merged["breaker"]["opens"] == 1
    assert merged["breaker"]["rows_nonfinite"] == 3
    assert merged["latency_ms"]["p99"] == 9.0
    assert merged["data_contract"]["drift_js_max"] == 0.1
    assert merged["replicas"] == 2
    assert merged["model_version"] == "v1"
    assert merged == mod(REF, "fleet").merge_serving_snapshots([a, b])


def test_channel_roundtrip_idle_and_peer_death():
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    ca, cb = FleetChannel(a), FleetChannel(b)
    payload = encode_records([{"x": 1.0}] * 8)
    ca.send(OP_SCORE, 7, {"tenant": None, "n_rows": 8}, payload)
    op, rid, meta, got = cb.recv()
    assert (op, rid, meta["n_rows"], got) == (OP_SCORE, 7, 8, payload)
    t0 = time.perf_counter()
    assert cb.recv(idle_return=True) is None
    assert time.perf_counter() - t0 < 1.0
    ca.close()
    with pytest.raises(ChannelClosedError):
        cb.recv()


def test_router_with_no_replicas_fails_loudly_not_hanging():
    from transmogrifai_tpu_torch.fleet import FleetError

    router = FleetRouter(max_queue=4)
    try:
        req = router.submit(records=[{"x": 1}])
        with pytest.raises(FleetError):
            req.wait(5.0)
    finally:
        router.close()


def test_router_reads_observed_throughput_from_shards():
    """Dispatch weights follow the shards' observed batch_rows_per_s (a
    fast replica reads as a shorter expected wait)."""
    router = FleetRouter(start=False)
    try:
        a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        fast = ReplicaHandle("replica-0", FleetChannel(a))
        slow = ReplicaHandle("replica-1", FleetChannel(b))
        router._handles = {"replica-0": fast, "replica-1": slow}
        docs = [
            {"instance": "replica-0",
             "views": {"serving/0": {"batch_rows_per_s": 100000.0,
                                     "latency_ms": {"p99": 4.0},
                                     "queue_depth": {},
                                     "rows_scored": 10}}},
            {"instance": "replica-1",
             "views": {"serving/0": {"batch_rows_per_s": 10000.0,
                                     "latency_ms": {"p99": 40.0},
                                     "queue_depth": {},
                                     "rows_scored": 10}}},
        ]
        assert router.refresh_from_shards(docs) == 2
        assert fast.expected_wait_s(512) < slow.expected_wait_s(512)
        assert router._pick(512) is fast
    finally:
        router.close()


# -- tests/test_fleet_faults.py: the unit surface ----------------------------

def test_parse_address_tcp_vs_unix():
    cases = ["tcp://10.0.0.7:7001", "tcp://:7001", "127.0.0.1:9000",
             "/tmp/replica-0.sock", "/tmp/odd:name.sock", "replica:zero"]
    assert parse_address("tcp://10.0.0.7:7001") == \
        ("tcp", ("10.0.0.7", 7001))
    assert parse_address("tcp://:7001") == ("tcp", ("127.0.0.1", 7001))
    assert parse_address("127.0.0.1:9000") == \
        ("tcp", ("127.0.0.1", 9000))
    assert parse_address("/tmp/replica-0.sock") == \
        ("unix", "/tmp/replica-0.sock")
    assert parse_address("/tmp/odd:name.sock") == \
        ("unix", "/tmp/odd:name.sock")
    assert parse_address("replica:zero") == ("unix", "replica:zero")
    ref = mod(REF, "fleet.channel").parse_address
    assert [parse_address(c) for c in cases] == [ref(c) for c in cases]


def _tcp_listener():
    lsock = listen("127.0.0.1:0")
    host, port = lsock.getsockname()[:2]
    return lsock, f"{host}:{port}"


def _recv_message(chan, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() <= deadline:
        msg = chan.recv()
        if msg is not None:
            return msg
    raise AssertionError("no message within the deadline")


def _handshake_server(lsock, accepts=1, magic=None, respond=True,
                      errors=None):
    """Accept ``accepts`` connections and answer each OP_HELLO (with an
    optionally-wrong magic, or silence): the worker side of the
    handshake, small enough to drive every client failure mode."""

    def run():
        for _ in range(accepts):
            try:
                chan = accept(lsock, 10.0)
            except ChannelClosedError:
                return
            if chan is None:
                return
            try:
                msg = _recv_message(chan)
                if respond:
                    meta = chan.hello_reply_meta()
                    if magic is not None:
                        meta["magic"] = magic
                    chan.send(OP_HELLO, msg[1], meta)
                try:
                    _recv_message(chan, timeout_s=5.0)
                except AssertionError:
                    pass
            except (ChannelClosedError, ChannelProtocolError) as e:
                if errors is not None:
                    errors.append(e)
            finally:
                chan.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_tcp_roundtrip_and_crc_corruption_detected():
    lsock, address = _tcp_listener()
    server_chan = {}
    ready = threading.Event()

    def server():
        server_chan["c"] = accept(lsock, 10.0)
        ready.set()

    threading.Thread(target=server, daemon=True).start()
    client = connect(address, timeout_s=10.0, handshake=False)
    assert ready.wait(10.0)
    srv = server_chan["c"]
    try:
        payload = b"\x00\x01" * 4096
        client.send(OP_SCORE, 7, {"n_rows": 3}, payload)
        op, rid, meta, got = _recv_message(srv)
        assert (op, rid, meta["n_rows"]) == (OP_SCORE, 7, 3)
        assert bytes(got) == payload
        _faults.configure("channel.corrupt_frame:on=1")
        client.send(OP_SCORE, 8, {"n_rows": 3}, payload)
        assert client.corrupt_injected == 1
        with pytest.raises(ChannelProtocolError, match="CRC"):
            _recv_message(srv)
        assert srv.protocol_errors == 1
        assert srv.closed
        assert srv.stats()["protocol_errors"] == 1
    finally:
        client.close()
        srv.close()
        lsock.close()


def test_handshake_rejects_cross_wired_magic():
    lsock, address = _tcp_listener()
    _handshake_server(lsock, magic="not-txfleet")
    try:
        with pytest.raises(ChannelProtocolError, match="cross-wired"):
            connect(address, timeout_s=5.0)
    finally:
        lsock.close()


def test_handshake_silence_times_out_bounded():
    lsock, address = _tcp_listener()
    _handshake_server(lsock, accepts=8, respond=False)
    t0 = time.monotonic()
    try:
        with pytest.raises(ChannelTimeoutError, match="handshake"):
            connect(address, timeout_s=0.6, handshake_timeout_s=0.2)
    finally:
        lsock.close()
    assert time.monotonic() - t0 < 5.0


def test_handshake_completes_and_records_peer():
    lsock, address = _tcp_listener()
    _handshake_server(lsock)
    try:
        chan = connect(address, timeout_s=5.0)
        assert chan.peer["magic"] == WIRE_MAGIC
        assert chan.peer["pid"] > 0
        chan.close()
    finally:
        lsock.close()


def test_handshake_across_packages():
    """A reference listener answers the port's handshake (and the other
    way round): the two fleets speak one wire."""
    for server_pkg, client_pkg in ((REF, PORT), (PORT, REF)):
        srv_ch = mod(server_pkg, "fleet.channel")
        lsock = srv_ch.listen("127.0.0.1:0")
        host, port = lsock.getsockname()[:2]
        done = threading.Event()

        def run():
            chan = srv_ch.accept(lsock, 10.0)
            try:
                msg = _recv_message(chan)
                chan.send(srv_ch.OP_HELLO, msg[1], chan.hello_reply_meta())
                done.wait(5.0)
            finally:
                chan.close()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        try:
            chan = mod(client_pkg, "fleet.channel").connect(
                f"{host}:{port}", timeout_s=5.0)
            assert chan.peer["magic"] == WIRE_MAGIC
            chan.close()
        finally:
            done.set()
            t.join(timeout=5.0)
            lsock.close()


def test_reconnect_storm_drops_connections_then_recovers():
    lsock, address = _tcp_listener()
    errors: list = []
    _handshake_server(lsock, accepts=4, errors=errors)
    _faults.configure("fleet.reconnect_storm:every=1:times=2")
    try:
        for _ in range(2):
            with pytest.raises(ChannelProtocolError,
                               match="reconnect storm"):
                connect(address, timeout_s=5.0)
        chan = connect(address, timeout_s=5.0)
        assert chan.peer["magic"] == WIRE_MAGIC
        chan.close()
    finally:
        lsock.close()


def _drive_health(pkg):
    h = mod(pkg, "fleet").ReplicaHealth(eject_after=2)
    trail = [h.state, h.snapshot()["state_code"]]
    trail.append(h.record_failure("response timeout", 1.0))
    trail += [h.state, h.consecutive_failures]
    h.record_success(2.5, 1.5)
    trail += [h.consecutive_failures, h.last_rtt_ms]
    trail.append(h.record_failure("response timeout", 2.0))
    trail.append(h.record_failure("response timeout", 2.1))
    trail += [h.state, h.ejections, h.ejected_at]
    h.force_eject("channel dead", 2.2)
    trail.append(h.ejections)
    h.record_success(1.0, 2.3)
    trail.append(h.state)
    h.begin_probe(3.0)
    trail += [h.state, h.probes_sent]
    h.probe_failed("probe unanswered", 3.5)
    trail += [h.state, h.probes_failed, h.snapshot()["state_code"]]
    h.begin_probe(4.0)
    trail.append(h.readmit(4.2))
    trail += [h.state, h.readmissions, h.consecutive_failures,
              h.readmitted_at]
    trail.append(h.readmit(4.3))
    trail.append(h.readmissions)
    trail.append([t["to"] for t in h.transitions])
    return trail


def test_replica_health_state_machine():
    trail = _drive_health(PORT)
    assert trail == [
        "healthy", 0, False, "healthy", 1, 0, 2.5, False, True,
        "ejected", 1, 2.1, 1, "ejected", "probing", 1, "ejected", 1, 2,
        True, "healthy", 1, 0, 4.2, False, 1,
        ["ejected", "probing", "ejected", "probing", "healthy"]]
    assert trail == _drive_health(REF)
    with pytest.raises(ValueError):
        ReplicaHealth(eject_after=0)


def test_brownout_sheds_low_priority_below_quorum():
    router = FleetRouter(start=False, quorum=2,
                         tenant_priority={"vip": 5},
                         brownout_min_priority=1)
    try:
        with pytest.raises(BrownoutShedError, match="brownout"):
            router.submit(records=[{"r": 1}])
        with pytest.raises(QueueFullError):
            router.submit(records=[{"r": 1}], tenant="batch-job")
        req = router.submit(records=[{"r": 1}], tenant="vip")
        assert req is not None
        snap = router.snapshot()
        assert snap["shed_brownout"] == 2
        assert snap["healthy_replicas"] == 0 and snap["quorum"] == 2
        assert router.health_snapshot()["shed_brownout"] == 2
    finally:
        router.close(timeout_s=5.0)


def test_fleet_result_decode_error_names_request_and_replica():
    from transmogrifai_tpu_torch.fleet import encode_results

    counted = []
    res = FleetResult(
        {"request_id": 41, "instance": "replica-3", "n_rows": 2},
        b"\x80\x05not-a-pickle",
        on_decode_error=lambda: counted.append(1))
    with pytest.raises(FleetDecodeError) as ei:
        _ = res.results
    msg = str(ei.value)
    assert "request 41" in msg and "replica-3" in msg
    assert counted == [1]
    ok = FleetResult({"n_rows": 1}, encode_results([{"p": 0.5}]))
    assert ok.results == [{"p": 0.5}]


def test_router_counts_decode_errors():
    router = FleetRouter(start=False)
    try:
        router._count_decode_error()
        assert router.snapshot()["decode_errors"] == 1
        assert router.health_snapshot()["decode_errors"] == 1
    finally:
        router.close(timeout_s=5.0)


def test_router_snapshot_keys_equal_to_reference():
    """The ``fleet_router`` and ``fleet_health`` views of an idle router
    carry the reference's keys and values."""
    got, want = FleetRouter(start=False), mod(REF, "fleet").FleetRouter(
        start=False)
    try:
        assert got.snapshot() == want.snapshot()
        assert got.health_snapshot() == want.health_snapshot()
    finally:
        got.close(timeout_s=5.0)
        want.close(timeout_s=5.0)


def test_health_views_extracts_fleet_health_from_metrics_doc():
    from transmogrifai_tpu_torch.obs.fleet import (
        autoscaler_views,
        health_views,
    )

    doc = {"views": {
        "fleet_router/1": {"rows_ok": 5},
        "fleet_health/1": {"ejections": 2,
                           "replicas": {"replica-0": {"state": "healthy"}}},
        "fleet_health": {"ejections": 0, "replicas": {}},
        "autoscaler/0": {"target": 3},
    }}
    got = dict(health_views(doc))
    assert set(got) == {"fleet_health/1", "fleet_health"}
    assert got["fleet_health/1"]["ejections"] == 2
    assert dict(health_views({"views": {"serving/1": {}}})) == {}
    assert dict(health_views({})) == {}
    ref = mod(REF, "obs.fleet")
    assert got == dict(ref.health_views(doc))
    assert dict(autoscaler_views(doc)) == dict(ref.autoscaler_views(doc)) \
        == {"autoscaler/0": {"target": 3}}


@pytest.mark.parametrize("name", ["FleetAutoscaler", "ScaleGovernor",
                                  "AutoscaleDecision"])
def test_autoscaler_names_raise_naming_item_12(name):
    """The autoscaler's names, once raises, are importable from the port's
    ``fleet`` and listed in its ``__all__`` as in the reference's; an
    unknown name is still an ``AttributeError``."""
    fleet = mod(PORT, "fleet")
    obj = getattr(fleet, name)
    assert obj is getattr(mod(PORT, "fleet.autoscaler"), name)
    assert name in fleet.__all__
    assert name in mod(REF, "fleet").__all__
    with pytest.raises(AttributeError):
        getattr(fleet, "NoSuchName")


def test_frame_header_layout():
    """The frame layout spelled out: a little-endian length, the CRC32 of
    the body, then op, request id and meta length ahead of the meta and
    payload."""
    frame = _frames(PORT, MESSAGES[:1])
    prefix = struct.Struct("<QI")
    body = frame[prefix.size:]
    length, crc = prefix.unpack_from(frame)
    assert length == len(body) and crc == zlib.crc32(body)
    op, rid, meta_len = struct.Struct("<BQI").unpack_from(body)
    assert (op, rid) == (OP_SCORE, 7)
    assert len(body) == 13 + meta_len + len(MESSAGES[0][3])
