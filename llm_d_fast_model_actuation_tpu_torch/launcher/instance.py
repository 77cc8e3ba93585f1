"""One engine instance: a child process running the port's engine server.

The port of the JAX package's ``launcher/instance.py`` (the reference's
``VllmInstance``, launcher.py:157-340): the status vocabulary (started /
already_running / running / stopped / not_running / terminated), a log
file per instance dup2'd over the child's stdout and stderr, SIGTERM and
then SIGKILL to the child's process group, crash detection by the child's
``multiprocessing`` sentinel fd registered on the event loop (no polling),
and ranged log reads.

GPU deltas:

* ``gpu_uuids`` become ``CUDA_VISIBLE_DEVICES`` with
  ``CUDA_DEVICE_ORDER=PCI_BUS_ID`` (``chiptranslator.py``); the child runs
  on those cards, as ``cuda:0`` and up, unless its options say ``--device
  cpu``.
* Children come from a ``forkserver``, not from a fork of the launcher.
  A child may initialize CUDA only if the process it was forked from
  never did, and is safe only if that process held no lock in another
  thread at the fork. The launcher runs its REST server, an executor and
  restart timers on threads; the fork server is a single-threaded process
  that imports torch and the port's modules once (``main.py:preload``)
  and forks every child from there, so children still start with warm
  modules. It is started by exec, so it inherits none of the launcher's
  sockets (no need for the reference's ``_close_inherited_sockets``), nor
  its later environment: the ``FMA_RESTARTED`` stamp of a supervised
  restart and the trace context of the create or restart
  (``FMA_TRACEPARENT``, which the reference stamps into the launcher's
  environment around its fork) travel as arguments (:func:`child_main`).
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import shlex
import signal
import tempfile
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ..api import constants
from ..utils import prom, tracing
from .chiptranslator import ChipTranslator

logger = logging.getLogger(__name__)

MAX_LOG_RESPONSE_BYTES = 1 << 20  # 1 MiB per ranged-log response

#: every child is forked by this context's fork server
CONTEXT = multiprocessing.get_context("forkserver")


def replace_model_option(
    options: str, model: str, checkpoint_dir: str = ""
) -> str:
    """Rewrite the ``--model`` (and ``--checkpoint-dir``) values in an
    engine options string. After a hot-swap the child serves a different
    model than it was forked with; the stored config must describe reality
    (status responses, and any future restart of the instance), so the OLD
    model's checkpoint dir never survives attached to the new model's
    name."""
    parts = shlex.split(options or "")
    out: List[str] = []
    replaced = False
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "--model" and i + 1 < len(parts):
            out += ["--model", model]
            i += 2
            replaced = True
        elif p.startswith("--model="):
            out.append(f"--model={model}")
            i += 1
            replaced = True
        elif p == "--checkpoint-dir" and i + 1 < len(parts):
            i += 2  # dropped; re-added below if the swap supplied one
        elif p.startswith("--checkpoint-dir="):
            i += 1
        else:
            out.append(p)
            i += 1
    if not replaced:
        out = ["--model", model] + out
    if checkpoint_dir:
        out += ["--checkpoint-dir", checkpoint_dir]
    return shlex.join(out)


class InvalidInstanceConfig(Exception):
    """The instance config is semantically invalid (e.g. unknown chip ID)."""


class HalfMade(Exception):
    """Something other than start() was the first op on an instance."""

    def __init__(self, instance_id: str) -> None:
        super().__init__(instance_id)
        self.instance_id = instance_id


class LogRangeNotAvailable(Exception):
    def __init__(self, requested: int, total: int) -> None:
        super().__init__(f"start {requested} beyond total {total}")
        self.requested = requested
        self.total = total


@dataclass
class InstanceConfig:
    """Wire config of one instance (reference VllmConfig, launcher.py:64-68).

    Serialized with the reference's field names (`options`, `gpu_uuids`,
    `env_vars`, `annotations`) so the reference's Go launcher client talks to
    this launcher unchanged; `chip_ids` is accepted as an input alias."""

    options: str = ""
    chip_ids: Optional[List[str]] = None
    env_vars: Optional[Dict[str, str]] = None
    annotations: Optional[Dict[str, str]] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"options": self.options}
        if self.chip_ids is not None:
            d["gpu_uuids"] = list(self.chip_ids)
        if self.env_vars is not None:
            d["env_vars"] = dict(self.env_vars)
        if self.annotations is not None:
            d["annotations"] = dict(self.annotations)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InstanceConfig":
        if "options" not in d:
            raise ValueError("instance config requires 'options'")
        chips = d.get("chip_ids", d.get("gpu_uuids"))
        return cls(
            options=str(d["options"]),
            chip_ids=None if chips is None else [str(c) for c in chips],
            env_vars=None if d.get("env_vars") is None else dict(d["env_vars"]),
            annotations=None
            if d.get("annotations") is None
            else dict(d["annotations"]),
        )


def engine_kickoff(config: InstanceConfig, log_path: str) -> None:
    """Child-process body: new process group, stdio -> log file, env, then
    the port's engine server (its modules already imported in the fork
    server, when the launcher preloads)."""
    os.setpgrp()
    fd = os.open(log_path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    if fd > 2:
        os.close(fd)
    for k, v in (config.env_vars or {}).items():
        os.environ[k] = str(v)
    # the instance's own FMA_TRACING / FMA_TRACE_BUFFER win over the
    # state the fork server had (FMA_TRACEPARENT stays for engine.start)
    tracing.reset_after_fork()
    from ..engine.server import parse_engine_options, run_server

    run_server(parse_engine_options(config.options))


def child_main(kickoff, config: InstanceConfig, log_path: str, restart: bool,
               traceparent: Optional[str] = None) -> None:
    """What the fork server's child runs: the supervised-restart stamp
    (``FMA_RESTARTED=1``) and the launcher's trace context
    (``FMA_TRACEPARENT``, the parent of the engine's ``engine.start``
    span), both of which the reference sets in the launcher's environment
    around its fork, then ``kickoff``. The fork copied the fork server's
    span rings and metric registry: the rings are dropped
    (``tracing.reset_after_fork``) before the context is set, and the
    launcher's families leave the registry (they belong to the
    launcher's ``/metrics``)."""
    if restart:
        os.environ["FMA_RESTARTED"] = "1"
    tracing.reset_after_fork()
    if traceparent:
        os.environ[tracing.TRACEPARENT_ENV] = traceparent
    else:
        os.environ.pop(tracing.TRACEPARENT_ENV, None)
    prom.unregister("fma_launcher_")
    kickoff(config, log_path)


class EngineInstance:
    def __init__(
        self,
        instance_id: str,
        config: InstanceConfig,
        translator: ChipTranslator,
        log_dir: str = "",
        kickoff=engine_kickoff,
    ) -> None:
        # Translate chip IDs to device-pinning env at construction time
        # (the reference's CUDA_VISIBLE_DEVICES injection, launcher.py:175-191).
        if config.chip_ids:
            try:
                env = translator.env_for(config.chip_ids)
            except KeyError as e:
                raise InvalidInstanceConfig(f"unknown chip id {e.args[0]!r}")
            config.env_vars = {**(config.env_vars or {}), **env}
            logger.info(
                "instance %s: chips %s -> CUDA_VISIBLE_DEVICES=%s",
                instance_id,
                config.chip_ids,
                env["CUDA_VISIBLE_DEVICES"],
            )
        self.instance_id = instance_id
        self.config = config
        self.process: Optional[multiprocessing.process.BaseProcess] = None
        self.last_revision: Optional[int] = None
        self._kickoff = kickoff
        self._sentinel_active = False
        self._sentinel_loop = None
        self._on_exit_callback = None
        self._log_file_path = os.path.join(
            log_dir or tempfile.gettempdir(), f"launcher-{os.getpid()}-engine-{instance_id}.log"
        )

    # -- state rendering -----------------------------------------------------

    def _make_state(self, status: str) -> Dict[str, Any]:
        return {
            "status": status,
            "instance_id": self.instance_id,
            "revision": self.last_revision,
            # the child's pid (None pre-start): fault drills and the
            # supervisor e2e need a real process to signal
            "pid": self.process.pid if self.process is not None else None,
            **self.config.to_dict(),
        }

    # -- lifecycle -----------------------------------------------------------

    def start(
        self, fresh_log: bool = True, restart: bool = False
    ) -> Dict[str, Any]:
        if self.process and self.process.is_alive():
            return self._make_state(constants.STATUS_ALREADY_RUNNING)
        if fresh_log or not os.path.exists(self._log_file_path):
            open(self._log_file_path, "wb").close()
        else:
            # supervised restart: append below the crash forensics (the
            # kickoff opens O_APPEND), with a marker separating the lives
            with open(self._log_file_path, "ab") as f:
                f.write(b"\n--- supervised restart ---\n")
        self.process = CONTEXT.Process(
            target=child_main,
            # the current span (launcher.create_instance or
            # launcher.restart) is the child's parent
            args=(self._kickoff, self.config, self._log_file_path, restart, tracing.current_traceparent()),
        )
        self.process.start()
        return self._make_state(constants.STATUS_STARTED)

    def stop(self, timeout: float = 10) -> Dict[str, Any]:
        if self.process is None:
            raise HalfMade(self.instance_id)
        if not self.process.is_alive():
            self._cleanup_log_file()
            return self._make_state(constants.STATUS_NOT_RUNNING)
        self.process.terminate()  # graceful: SIGTERM to the server
        self.process.join(timeout=timeout)
        if self.process.is_alive():
            try:
                os.killpg(self.process.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.process.join()
        self._cleanup_log_file()
        return self._make_state(constants.STATUS_TERMINATED)

    def get_status(self) -> Dict[str, Any]:
        if self.process is None:
            raise HalfMade(self.instance_id)
        return self._make_state(
            constants.STATUS_RUNNING if self.process.is_alive() else constants.STATUS_STOPPED
        )

    # -- crash detection -----------------------------------------------------

    def start_sentinel_watcher(self, on_exit_callback) -> None:
        """Register the child's sentinel fd on the running event loop; it
        becomes readable when the child dies (with a fork server: when the
        server has reaped it and sent its exit status)."""
        import asyncio

        if self.process is None:
            raise HalfMade(self.instance_id)
        self._on_exit_callback = on_exit_callback
        self._sentinel_loop = loop = asyncio.get_running_loop()
        loop.add_reader(self.process.sentinel, self._on_sentinel_exit)
        self._sentinel_active = True

    def _on_sentinel_exit(self) -> None:
        self._sentinel_loop.remove_reader(self.process.sentinel)
        # a cancel from another thread leaves the fd registered until the
        # loop gets to it: the child's end is then not a crash
        crashed = self._sentinel_active
        self._sentinel_active = False
        # Reap so exitcode is populated (a short blocking join is
        # effectively instant here).
        self.process.join(timeout=2)
        if crashed and self._on_exit_callback:
            self._on_exit_callback(self.instance_id, self.process.exitcode)

    def cancel_sentinel_watcher(self) -> None:
        """Stop crash detection, from any thread: once this returns, the
        child's end calls back nothing. The fd is unregistered on the
        loop's thread (a stop runs on the REST server's executor)."""
        import asyncio

        if not self._sentinel_active or self.process is None:
            return
        self._sentinel_active = False
        loop, fd = self._sentinel_loop, self.process.sentinel
        try:
            on_loop = asyncio.get_running_loop() is loop
        except RuntimeError:
            on_loop = False
        if on_loop:
            loop.remove_reader(fd)
        elif not loop.is_closed():
            loop.call_soon_threadsafe(loop.remove_reader, fd)

    # -- logs ----------------------------------------------------------------

    def _cleanup_log_file(self) -> None:
        try:
            os.unlink(self._log_file_path)
        except FileNotFoundError:
            pass

    def get_log_bytes(
        self, start: int = 0, end: Optional[int] = None
    ) -> tuple:
        """(content, total_length) for [start, end] (inclusive), capped at
        MAX_LOG_RESPONSE_BYTES. Raises LogRangeNotAvailable if start >= total."""
        try:
            total = os.path.getsize(self._log_file_path)
        except FileNotFoundError:
            total = 0
        if start >= total:
            raise LogRangeNotAvailable(start, total)
        if end is None:
            read_end = min(start + MAX_LOG_RESPONSE_BYTES - 1, total - 1)
        else:
            read_end = min(end, total - 1)
        with open(self._log_file_path, "rb") as f:
            f.seek(start)
            data = f.read(read_end - start + 1)
        return data, total
