"""Multi-node serving data plane: leader/follower lockstep stepping.

Port of ``llm_d_fast_model_actuation_tpu/engine/multihost.py``. A gang
engine is ONE sharded engine whose ranks live in several processes, one
per node (``parallel/multihost.py`` plans them, ``controller/gang.py``
forms them): every process must run the same forwards in the same order
with the same host inputs, or the exchanges inside them
(``parallel/mesh.py``) never pair up. The gang joins one
``torch.distributed`` Gloo group (:func:`join_gang`); this module keeps it
in lockstep while SERVING:

  * process 0 (the **leader**) runs the normal engine loop and the HTTP
    API. Before every prefill, suffix-prefill and chunk forward it
    broadcasts a fixed-shape control frame — the kind, the static
    arguments (prefill bucket, chunk length) and the host scheduler
    mirrors — packed into one CPU byte tensor on the gang's frame group
    (:class:`LockstepLeader`);
  * processes 1..N-1 (**followers**) run :func:`follower_loop`: receive a
    frame, replay the same forward on their own ranks through the
    engine's own entry points (``InferenceEngine.prefill_forward``,
    ``suffix_forward``, ``chunk_eager``), and keep their device state
    (KV pool, scheduler tensors) in lockstep. Followers never sample:
    sampling runs where the logits are gathered, on the leader, and
    inside a chunk each step's tokens reach the followers as bytes
    (``engine/engine.py:chunk_body``), where the JAX package's compiled
    program samples the same token on every process.

The frame has the JAX package's keys, dtypes and shapes for the same
config (``skeys`` carries each slot's stream seed, as two ``uint32``
words; a follower draws nothing from it). The followers' forwards are
eager, as every mesh chunk is (CUDA graphs belong to one device).

**Idle followers.** A follower waits for its next frame inside the
broadcast while the leader is idle, for as long as the leader stays idle.
The frame group therefore has a timeout beyond any idle period (a year),
while the group the mesh's exchanges use keeps an ordinary one
(:data:`COLLECTIVE_TIMEOUT`, Gloo's 30 minutes): failure
detection is the watchdog's (:class:`GangWatchdog`), as in the JAX
package.

**Transport.** Gloo over TCP, bytes only. NCCL is not used: it refuses two
ranks of one communicator on one device, and a gang rehearsed on one card
puts both of its processes on it.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import logging
import os
import socket
import socketserver
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: shared-secret env for heartbeat authentication: every gang member gets
#: the same value from the coordinator's ISC env. Unset falls back to a
#: fixed default — the token then only proves "same coordinator address",
#: which still stops a stray prober on a hostNetwork node from keeping a
#: half-dead gang looking alive.
GANG_HB_SECRET_ENV = "FMA_GANG_HB_SECRET"


def gang_heartbeat_token(coordinator_address: str) -> str:
    """Per-gang heartbeat token: HMAC of the coordinator address under the
    shared secret. Binds a ping to THIS gang — two gangs whose heartbeat
    ports collide across restarts (the port is derived, not reserved)
    cannot accept each other's pings, and an unauthenticated writer
    cannot refresh a member's liveness."""
    secret = os.environ.get(GANG_HB_SECRET_ENV, "") or "fma-gang"
    return hmac.new(secret.encode(), coordinator_address.encode(), hashlib.sha256).hexdigest()[:16]


#: Heartbeat port = coordinator port + this offset. The gang coordinator
#: draws per-gang coordinator ports from [base, base+4096)
#: (``controller/gang.py``), so base+4096.. is collision-free against other
#: gangs' coordinators on the same hostNetwork node.
HEARTBEAT_PORT_OFFSET = 4096

#: Exit code for "a gang peer died while the data plane may be blocked in
#: an exchange": the launcher's sentinel sees the process exit and the
#: crash chain (STOPPED -> notifier -> controller deletes the requester ->
#: gang degrades -> re-forms) takes over, the path a one-node engine crash
#: takes (``launcher/instance.py``).
EXIT_GANG_PEER_LOST = 13


class GangWatchdog:
    """Data-plane failure detector for a lockstep gang.

    The lockstep protocol is built on exchanges, and an exchange whose
    peer died may never complete — a wedged gang serves nothing and looks
    alive. This gives the gang's data plane the reference's process-level
    failure chain: any member death converts, within ``timeout`` seconds,
    into every other member exiting non-zero, which the per-member
    launchers' sentinels all see.

    Star topology over the leader's host (every member already knows the
    coordinator address; no extra discovery):

      * the leader runs a tiny TCP responder on coordinator_port +
        HEARTBEAT_PORT_OFFSET and tracks when each follower last pinged;
        a follower silent for ``timeout`` seconds (or never arrived within
        ``join_grace``) kills the leader;
      * followers ping every ``interval`` seconds; a leader unreachable for
        ``timeout`` seconds kills the follower.

    A follower death thus kills the leader directly, and the leader's
    death cascades to the remaining followers — whole-gang teardown from
    any single fault, without full pairwise connectivity.

    Heartbeats ride their own threads and sockets, never the exchange
    stream, so a gang busy in a long forward (a big prefill) keeps
    answering and is NOT torn down: timeouts fire only when a process is
    actually gone (its responder or prober dies with it).
    """

    def __init__(
        self,
        process_id: int,
        num_processes: int,
        coordinator_address: str,
        interval: float = 2.0,
        timeout: float = 20.0,
        join_grace: float = 60.0,
        on_death: Optional[Callable[[str], None]] = None,
    ) -> None:
        host, _, port = coordinator_address.rpartition(":")
        self.process_id = process_id
        self.num_processes = num_processes
        self.leader_host = host
        self.hb_port = int(port) + HEARTBEAT_PORT_OFFSET
        #: per-gang auth token (:func:`gang_heartbeat_token`): carried in
        #: every ping, verified by the responder — an unauthenticated ping
        #: refreshes nothing and gets no "ok"
        self.token = gang_heartbeat_token(coordinator_address)
        # a timeout needs several missed pings' slack, or scheduler jitter
        # on a single late ping reads as a death: keep >= 4 intervals per
        # timeout window by shrinking the interval for small timeouts
        self.interval = min(interval, max(0.05, timeout / 4.0))
        self.timeout = timeout
        self.join_grace = max(join_grace, timeout)
        self._on_death = on_death or self._die
        self._stop = threading.Event()
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._threads: list = []
        #: leader: follower pid -> monotonic last-heard
        self._last_seen: Dict[int, float] = {}

    @staticmethod
    def _die(reason: str) -> None:
        logger.critical(
            "gang watchdog: %s — exiting %d so the launcher sentinel tears this member down (the data plane "
            "may be wedged in an exchange and cannot unwind in-process)", reason, EXIT_GANG_PEER_LOST,
        )
        # not sys.exit: the lockstep thread may be blocked inside an
        # exchange that will never return; only the process can die
        os._exit(EXIT_GANG_PEER_LOST)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.num_processes <= 1:
            return
        if self.process_id == 0:
            self._start_responder()
            t = threading.Thread(target=self._leader_monitor, daemon=True, name="gang-hb-monitor")
        else:
            t = threading.Thread(target=self._follower_prober, daemon=True, name="gang-hb-prober")
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        """Clean shutdown (the leader's SHUTDOWN frame was delivered): stop
        probing and monitoring so the orderly teardown is not read as a
        death."""
        self._stop.set()
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except Exception:  # noqa: BLE001
                pass

    # -- leader side ---------------------------------------------------------

    def _start_responder(self) -> None:
        last_seen = self._last_seen
        token = self.token

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                try:
                    line = self.rfile.readline(96).decode().split()
                    # "hb <pid> <token>": the token must verify or the ping
                    # neither refreshes liveness nor gets an "ok" (constant
                    # time compare: the token is a shared-secret MAC)
                    if len(line) == 3 and line[0] == "hb" and hmac.compare_digest(line[2], token):
                        last_seen[int(line[1])] = time.monotonic()
                        self.wfile.write(b"ok\n")
                except (ValueError, OSError):
                    pass

        class _HBServer(socketserver.ThreadingTCPServer):
            # confined to the watchdog's server; mutating the stdlib class
            # attribute would flip SO_REUSEADDR on for unrelated servers
            allow_reuse_address = True

        try:
            self._server = _HBServer(("0.0.0.0", self.hb_port), Handler)
        except OSError as e:
            # name the port-derivation scheme: "address already in use" on
            # a number nobody configured is otherwise undebuggable
            raise RuntimeError(
                f"gang heartbeat responder failed to bind 0.0.0.0:{self.hb_port} (= coordinator port "
                f"{self.hb_port - HEARTBEAT_PORT_OFFSET} + HEARTBEAT_PORT_OFFSET {HEARTBEAT_PORT_OFFSET}; the "
                f"gang coordinator draws coordinator ports from a range whose +{HEARTBEAT_PORT_OFFSET} offset "
                f"must stay free on this node): {e}"
            ) from e
        self._server.daemon_threads = True
        t = threading.Thread(target=self._server.serve_forever, daemon=True, name="gang-hb-server")
        t.start()
        self._threads.append(t)

    def _leader_monitor(self) -> None:
        started = time.monotonic()
        expected = set(range(1, self.num_processes))
        while not self._stop.wait(self.interval):
            now = time.monotonic()
            for pid in expected:
                seen = self._last_seen.get(pid)
                if seen is None:
                    # the group formed, so the member process existed; its
                    # first ping should land within an interval or two
                    if now - started > self.join_grace:
                        self._on_death(f"follower {pid} never sent a heartbeat within {self.join_grace:.0f}s "
                                       "of gang start")
                        return
                elif now - seen > self.timeout:
                    self._on_death(f"follower {pid} heartbeat silent for {now - seen:.1f}s (> {self.timeout:.0f}s)")
                    return

    # -- follower side -------------------------------------------------------

    def _ping(self) -> bool:
        try:
            with socket.create_connection((self.leader_host, self.hb_port), timeout=self.interval + 1) as s:
                s.sendall(f"hb {self.process_id} {self.token}\n".encode())
                s.settimeout(self.interval + 1)
                return s.recv(8).startswith(b"ok")
        except OSError:
            return False

    def _follower_prober(self) -> None:
        last_ok = time.monotonic()
        reached = False  # the leader's responder answered at least once
        while not self._stop.wait(self.interval):
            if self._ping():
                last_ok = time.monotonic()
                reached = True
                continue
            silent = time.monotonic() - last_ok
            # before first contact the leader may still be building or
            # binding its responder: allow the same grace the leader gives
            # followers, then the steady-state timeout applies
            allowed = self.timeout if reached else self.join_grace
            if silent > allowed:
                self._on_death(f"leader heartbeat unreachable for {silent:.1f}s (> {allowed:.0f}s)")
                return


# -- the process group ---------------------------------------------------------

#: how long a gang's exchanges inside the forwards may wait for a peer
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=1800)
#: how long a follower may wait for its next frame: beyond any idle spell
FRAME_TIMEOUT = datetime.timedelta(days=365)


@dataclass
class Gang:
    """This process's membership of a gang: its place, and the two Gloo
    groups over every member (``collectives`` for the mesh's exchanges,
    ``frames`` for the lockstep frames)."""

    process_id: int
    num_processes: int
    coordinator_address: str
    collectives: Any
    frames: Any


def join_gang(coordinator_address: str, num_processes: int, process_id: int, join_timeout_s: float = 300.0) -> Gang:
    """Join the gang's ``torch.distributed`` group (Gloo over TCP; process
    0 hosts its store at ``coordinator_address``) and make its two groups.
    Blocks until every member joins, at most ``join_timeout_s``; raises if
    the group does not form (there is no one-process fallback)."""
    import torch.distributed as dist

    if not dist.is_gloo_available():
        raise RuntimeError("this PyTorch has no Gloo backend: a gang cannot form")
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=join_timeout_s),
    )
    collectives = dist.new_group(backend="gloo", timeout=COLLECTIVE_TIMEOUT)
    frames = dist.new_group(backend="gloo", timeout=FRAME_TIMEOUT)
    return Gang(process_id, num_processes, coordinator_address, collectives, frames)


# -- the lockstep frame --------------------------------------------------------

KIND_IDLE = 0
KIND_PREFILL = 1
KIND_CHUNK = 2
KIND_SLEEP = 3
KIND_WAKE = 4
KIND_SHUTDOWN = 5
KIND_PREFILL_SUFFIX = 6  #: prefix-cache hit or chunked prefill: a suffix segment


def _frame_template(cfg) -> Dict[str, np.ndarray]:
    b, p = cfg.max_batch, cfg.pages_per_seq
    return {
        "kind": np.zeros((), np.int32),
        #: prefill bucket | chunk T | sleep level
        "arg": np.zeros((), np.int32),
        #: prefill slot | sleep release flag
        "arg2": np.zeros((), np.int32),
        "seq_len": np.zeros((), np.int32),
        #: suffix prefill: absolute position of the first suffix token
        "start": np.zeros((), np.int32),
        "temp": np.zeros((), np.float32),
        "top_p": np.ones((), np.float32),
        "tokens": np.zeros((cfg.seq_len,), np.int32),
        #: chunk: rebuild the device scheduler state from the mirrors below
        "reupload": np.zeros((), np.int32),
        #: suffix prefill: the segment is the prompt's last (it samples)
        "advance_key": np.ones((), np.int32),
        "want_plp": np.zeros((), np.int32),
        "lt": np.zeros((b,), np.int32),
        "pos": np.zeros((b,), np.int32),
        "budget": np.zeros((b,), np.int32),
        "temps": np.zeros((b,), np.float32),
        "topps": np.ones((b,), np.float32),
        # penalties are refused for gangs (engine.add_request): these stay
        # zero, and the [b, vocab] count and bias arrays never cross the frame
        "pres": np.zeros((b,), np.float32),
        "freqs": np.zeros((b,), np.float32),
        "page_table": np.zeros((b, p), np.int32),
        #: per-slot stream seed (low, high 32-bit words)
        "skeys": np.zeros((b, 2), np.uint32),
        #: per-slot eos sensitivity (ignore_eos requests = 0)
        "eos_on": np.ones((b,), np.int32),
    }


def pack_frame(frame: Dict[str, np.ndarray]) -> torch.Tensor:
    """A frame as one CPU ``uint8`` tensor: each array's bytes in key order."""
    return torch.from_numpy(np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                                            for a in frame.values()]))


def unpack_frame(buf: torch.Tensor, template: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`pack_frame`, by ``template``'s keys, shapes
    and dtypes."""
    raw = buf.numpy()
    out, off = {}, 0
    for k, a in template.items():
        n = a.nbytes
        out[k] = raw[off:off + n].view(a.dtype).reshape(a.shape).copy()
        off += n
    if off != raw.size:
        raise ValueError(f"a frame of {raw.size} bytes for a template of {off}")
    return out


def _broadcast(frame: Dict[str, np.ndarray], group: Any) -> Dict[str, np.ndarray]:
    """Process 0's frame on every process of ``group`` (the others pass the
    template); a failed broadcast raises."""
    import torch.distributed as dist

    buf = pack_frame(frame)
    dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
    return unpack_frame(buf, frame)


def stream_seed_words(seed: int) -> np.ndarray:
    """A 64-bit stream seed as the frame's two ``uint32`` words."""
    v = int(seed) & 0xFFFF_FFFF_FFFF_FFFF
    return np.array([v & 0xFFFF_FFFF, v >> 32], np.uint32)


class LockstepLeader:
    """Installed on the leader's engine as ``engine.lockstep``; the engine
    calls these hooks immediately before its forwards, the service before
    a sleep, a wake and its shutdown. Frames go out one at a time."""

    def __init__(self, engine: Any, group: Any) -> None:
        self.engine = engine
        self.group = group
        self._template = _frame_template(engine.cfg)
        self._mu = threading.Lock()
        #: frames sent, and the seconds inside their broadcasts
        self.frames = 0
        self.frame_s = 0.0

    def _mirrors(self, f: Dict[str, np.ndarray]) -> None:
        e = self.engine
        f["lt"] = e._last_tokens.copy()
        f["pos"] = e._positions.copy()
        f["budget"] = e._budgets.copy()
        f["temps"] = e._temps.copy()
        f["topps"] = e._topps.copy()
        f["pres"] = e._pres.copy()
        f["freqs"] = e._freqs.copy()
        f["page_table"] = e._page_table.copy()
        skeys = np.zeros_like(self._template["skeys"])
        for s, req in enumerate(e._slots):
            if req is not None:
                skeys[s] = stream_seed_words(e.stream_seed(req))
        f["skeys"] = skeys
        f["eos_on"] = e._eos_on.copy()

    def _send(self, **fields: Any) -> None:
        f = dict(self._template)
        self._mirrors(f)
        for k, v in fields.items():
            f[k] = np.asarray(v, f[k].dtype)
        with self._mu:
            t0 = time.perf_counter()
            _broadcast(f, self.group)
            self.frame_s += time.perf_counter() - t0
            self.frames += 1

    # -- hooks ---------------------------------------------------------------

    def prefill(self, req: Any, bucket: int, want_plp: bool = False) -> None:
        tokens = np.zeros((self.engine.cfg.seq_len,), np.int32)
        tokens[: len(req.prompt)] = req.prompt
        self._send(kind=KIND_PREFILL, arg=bucket, arg2=req.slot, seq_len=len(req.prompt), temp=req.temperature,
                   top_p=req.top_p, tokens=tokens, want_plp=int(want_plp))

    def prefill_suffix(self, req: Any, bucket: int, start: int, seg_len: int = -1, advance_key: bool = True,
                       want_plp: bool = False) -> None:
        if seg_len < 0:
            seg_len = len(req.prompt) - start
        seg = req.prompt[start:start + seg_len]
        tokens = np.zeros((self.engine.cfg.seq_len,), np.int32)
        tokens[: len(seg)] = seg
        self._send(kind=KIND_PREFILL_SUFFIX, arg=bucket, arg2=req.slot, seq_len=len(seg), start=start,
                   temp=req.temperature, top_p=req.top_p, tokens=tokens, advance_key=int(advance_key),
                   want_plp=int(want_plp))

    def chunk(self, T: int, reupload: bool) -> None:
        self._send(kind=KIND_CHUNK, arg=T, reupload=int(reupload))

    def sleep(self, level: int, release: bool) -> None:
        self._send(kind=KIND_SLEEP, arg=level, arg2=int(release))

    def wake(self) -> None:
        self._send(kind=KIND_WAKE)

    def shutdown(self) -> None:
        self._send(kind=KIND_SHUTDOWN)


def follower_loop(engine: Any, sleeper: Optional[Any], group: Any) -> None:
    """Run a follower process until the leader broadcasts SHUTDOWN.

    ``engine`` must be built as the leader's is (same config, same seed,
    same mesh plan): the gang ships identical options to every member, so
    this holds by construction. A replay that raises ends the loop with
    the exception (the service fails its ``/health``)."""
    template = _frame_template(engine.cfg)
    while True:
        f = _broadcast(template, group)
        kind = int(f["kind"])
        if kind == KIND_SHUTDOWN:
            logger.info("follower: leader shut down")
            return
        if kind == KIND_PREFILL:
            _replay_prefill(engine, f)
        elif kind == KIND_PREFILL_SUFFIX:
            _replay_prefill_suffix(engine, f)
        elif kind == KIND_CHUNK:
            _replay_chunk(engine, f)
        elif kind == KIND_SLEEP and sleeper is not None:
            sleeper.sleep(int(f["arg"]), release=bool(int(f["arg2"])))
        elif kind == KIND_WAKE and sleeper is not None:
            sleeper.wake_up()


def _sync_mirrors(engine: Any, f: Dict[str, np.ndarray]) -> None:
    engine._last_tokens[:] = f["lt"]
    engine._positions[:] = f["pos"]
    engine._budgets[:] = f["budget"]
    engine._temps[:] = f["temps"]
    engine._topps[:] = f["topps"]
    engine._pres[:] = f["pres"]
    engine._freqs[:] = f["freqs"]
    engine._page_table[:] = f["page_table"]
    engine._eos_on[:] = f["eos_on"]
    engine._dirty = True


def _segment(f: Dict[str, np.ndarray]) -> np.ndarray:
    bucket = int(f["arg"])
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :] = f["tokens"][:bucket]
    return tokens


def _replay_prefill(engine: Any, f: Dict[str, np.ndarray]) -> None:
    _sync_mirrors(engine, f)
    n = int(f["seq_len"])
    engine.cold_prefills += 1
    engine._count_bucketed(int(f["arg"]), n)
    engine.prefill_forward(_segment(f), n, int(f["arg2"]), last_only=not int(f["want_plp"]))
    # no host read: the leader alone consumes tokens


def _replay_prefill_suffix(engine: Any, f: Dict[str, np.ndarray]) -> None:
    _sync_mirrors(engine, f)
    n = int(f["seq_len"])
    engine._count_bucketed(int(f["arg"]), n)
    engine.suffix_forward(_segment(f), int(f["start"]), n, int(f["arg2"]), last_only=not int(f["want_plp"]))


def _replay_chunk(engine: Any, f: Dict[str, np.ndarray]) -> None:
    T = int(f["arg"])
    if int(f["reupload"]) or engine._dirty:
        _sync_mirrors(engine, f)
        engine._upload_sched()
    engine.decode_chunks += 1
    engine.chunk_steps += T
    engine.chunk_eager(T, False)
