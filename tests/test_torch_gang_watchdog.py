"""The port's GangWatchdog (engine/multihost.py): gang data-plane failure
detection, held to tests/test_gang_watchdog.py's cases.

The lockstep protocol wedges if a member dies mid-exchange; the watchdog
converts any member death into every other member exiting, which the
launchers' sentinels turn into the normal crash chain. These tests drive
the watchdog with real sockets and injected death callbacks — no engine,
no gang — and hold its heartbeat token to the JAX package's."""

import threading
import time

from llm_d_fast_model_actuation_tpu_torch.engine.multihost import (
    EXIT_GANG_PEER_LOST,
    HEARTBEAT_PORT_OFFSET,
    GangWatchdog,
)

from conftest import free_port


def _mk(pid, port, deaths, **kw):
    defaults = dict(interval=0.1, timeout=0.6, join_grace=1.0)
    defaults.update(kw)
    return GangWatchdog(
        process_id=pid,
        num_processes=2,
        coordinator_address=f"127.0.0.1:{port}",
        on_death=lambda reason: deaths.append((pid, reason)),
        **defaults,
    )


def test_healthy_gang_stays_up():
    port = free_port() - HEARTBEAT_PORT_OFFSET
    deaths = []
    leader = _mk(0, port, deaths)
    follower = _mk(1, port, deaths)
    leader.start()
    follower.start()
    try:
        time.sleep(1.5)  # several timeout windows
        assert deaths == []
    finally:
        follower.stop()
        leader.stop()


def test_follower_death_kills_leader():
    port = free_port() - HEARTBEAT_PORT_OFFSET
    deaths = []
    leader = _mk(0, port, deaths)
    follower = _mk(1, port, deaths)
    leader.start()
    follower.start()
    try:
        time.sleep(0.5)  # follower checks in
        follower.stop()  # "dies": stops pinging
        t0 = time.monotonic()
        while not deaths and time.monotonic() - t0 < 3:
            time.sleep(0.05)
        assert deaths and deaths[0][0] == 0, deaths
        assert "follower 1" in deaths[0][1]
    finally:
        leader.stop()


def test_leader_death_kills_follower():
    port = free_port() - HEARTBEAT_PORT_OFFSET
    deaths = []
    leader = _mk(0, port, deaths)
    follower = _mk(1, port, deaths)
    leader.start()
    follower.start()
    try:
        time.sleep(0.4)
        leader.stop()  # responder gone
        t0 = time.monotonic()
        while not deaths and time.monotonic() - t0 < 3:
            time.sleep(0.05)
        follower_deaths = [d for d in deaths if d[0] == 1]
        assert follower_deaths, deaths
        assert "leader" in follower_deaths[0][1]
    finally:
        follower.stop()


def test_follower_that_never_joins_trips_join_grace():
    port = free_port() - HEARTBEAT_PORT_OFFSET
    deaths = []
    leader = _mk(0, port, deaths, join_grace=0.5)
    leader.start()
    try:
        t0 = time.monotonic()
        while not deaths and time.monotonic() - t0 < 3:
            time.sleep(0.05)
        assert deaths and "never sent a heartbeat" in deaths[0][1], deaths
    finally:
        leader.stop()


def test_stopped_watchdog_never_fires():
    """Clean shutdown: stop() before the peer disappears -> no death."""
    port = free_port() - HEARTBEAT_PORT_OFFSET
    deaths = []
    leader = _mk(0, port, deaths)
    follower = _mk(1, port, deaths)
    leader.start()
    follower.start()
    time.sleep(0.3)
    follower.stop()
    leader.stop()
    time.sleep(1.0)
    assert deaths == []


def test_single_process_watchdog_is_noop():
    deaths = []
    w = GangWatchdog(
        process_id=0, num_processes=1,
        coordinator_address="127.0.0.1:9",
        on_death=lambda r: deaths.append(r),
    )
    w.start()  # no threads, no sockets
    assert w._threads == []
    w.stop()
    assert deaths == []


def test_exit_code_is_distinct():
    # the launcher sentinel treats any non-zero exit as a crash; the
    # dedicated code makes gang teardowns recognizable in logs
    assert EXIT_GANG_PEER_LOST not in (0, 1, 2)


def test_heartbeat_requires_gang_token():
    """ADVICE round-5: the responder only accepts pings carrying the
    per-gang token (HMAC of coordinator address + shared secret env) —
    an unauthenticated or foreign-gang ping neither refreshes liveness
    nor gets an "ok"."""
    import socket

    from llm_d_fast_model_actuation_tpu_torch.engine.multihost import (
        gang_heartbeat_token,
    )

    port = free_port() - HEARTBEAT_PORT_OFFSET
    deaths = []
    leader = _mk(0, port, deaths, join_grace=30, timeout=30)
    leader.start()
    try:
        addr = ("127.0.0.1", port + HEARTBEAT_PORT_OFFSET)

        def ping(line: str) -> bytes:
            with socket.create_connection(addr, timeout=2) as s:
                s.sendall(line.encode())
                s.settimeout(2)
                try:
                    return s.recv(8)
                except TimeoutError:
                    return b""

        # legacy two-field ping (no token): rejected
        assert not ping("hb 1\n").startswith(b"ok")
        assert 1 not in leader._last_seen
        # wrong token (another gang / no secret agreement): rejected
        assert not ping("hb 1 deadbeefdeadbeef\n").startswith(b"ok")
        assert 1 not in leader._last_seen
        # the real token: accepted and liveness refreshed
        tok = gang_heartbeat_token(f"127.0.0.1:{port}")
        assert leader.token == tok
        assert ping(f"hb 1 {tok}\n").startswith(b"ok")
        assert 1 in leader._last_seen
    finally:
        leader.stop()


def test_heartbeat_token_varies_with_secret_and_address(monkeypatch):
    from llm_d_fast_model_actuation_tpu_torch.engine.multihost import (
        GANG_HB_SECRET_ENV,
        gang_heartbeat_token,
    )

    a = gang_heartbeat_token("10.0.0.1:1234")
    assert a == gang_heartbeat_token("10.0.0.1:1234")  # deterministic
    assert a != gang_heartbeat_token("10.0.0.2:1234")  # per-gang
    monkeypatch.setenv(GANG_HB_SECRET_ENV, "s3cret")
    assert gang_heartbeat_token("10.0.0.1:1234") != a  # secret-bound


def test_leader_bind_failure_names_port_offset_scheme():
    """A taken heartbeat port must fail with an error that explains the
    coordinator-port + HEARTBEAT_PORT_OFFSET derivation — 'address in
    use' on a number nobody configured is otherwise undebuggable."""
    import socket

    import pytest

    port = free_port() - HEARTBEAT_PORT_OFFSET
    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("0.0.0.0", port + HEARTBEAT_PORT_OFFSET))
    blocker.listen(1)
    deaths = []
    leader = _mk(0, port, deaths)
    try:
        with pytest.raises(RuntimeError) as ei:
            leader.start()
        msg = str(ei.value)
        assert "HEARTBEAT_PORT_OFFSET" in msg
        assert str(port) in msg and str(port + HEARTBEAT_PORT_OFFSET) in msg
    finally:
        blocker.close()
        leader.stop()


def test_heartbeat_token_equals_the_jax_packages(monkeypatch):
    """One gang may mix the packages' launchers: a ping's token is the JAX
    package's for the same secret and address."""
    from llm_d_fast_model_actuation_tpu.engine import multihost as jmh
    from llm_d_fast_model_actuation_tpu_torch.engine import multihost as tmh

    for addr in ("10.0.0.1:1234", "127.0.0.1:8476", "[::1]:9"):
        assert tmh.gang_heartbeat_token(addr) == jmh.gang_heartbeat_token(addr)
    monkeypatch.setenv(tmh.GANG_HB_SECRET_ENV, "s3cret")
    assert tmh.gang_heartbeat_token("10.0.0.1:1234") == jmh.gang_heartbeat_token("10.0.0.1:1234")
