"""Requester stub main: SPI + probes servers in one process.

The port of the JAX package's ``requester/main.py`` (reference parity:
cmd/requester/main.go:32-85 for real cards, cmd/test-requester for
emulated allocation), on asyncio streams. Backends:

  * ``--backend real``   — every card NVML sees, by UUID, and each one's
    memory in use from NVML (every process's, as ``nvidia-smi`` reads
    it); without NVML it raises, it never falls back to ``static``;
  * ``--backend env``    — the cards of ``$CUDA_VISIBLE_DEVICES`` (indices
    in PCI bus order) through a gpu-map file for ``$NODE_NAME`` (what the
    kube scheduler/device plugin would have granted);
  * ``--backend static`` — explicit ``--chips a,b,c`` (tests);
  * ``--backend alloc``  — claim ``--alloc-count`` cards of ``--chips`` on
    ``--node`` from the shared ``chip-allocations`` ConfigMap with the
    optimistic-concurrency loop (reference test-requester contention
    emulation, cmd/test-requester/gpu-allocation.go:41-257); claims are
    released on shutdown.

Only ``real`` reports memory; the others report 0 per card. On a machine
with cards:

    python -m llm_d_fast_model_actuation_tpu_torch.requester.main --backend real \\
        --spi-port 8081 --probes-port 8080
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
from typing import Callable, Dict, List

from .probes import ProbesServer
from .spi import LogSink, ReadyFlag, SpiServer

logger = logging.getLogger(__name__)


def real_cards() -> List[str]:
    """Every card NVML sees, by UUID, in PCI bus order; raises without
    NVML or without a card."""
    from ..native import nvml

    try:
        gpus = nvml.enumerate_gpus()
    except nvml.NvmlError as e:
        raise RuntimeError(f"the real backend needs NVML: {e}") from e
    if not gpus:
        raise RuntimeError("the real backend found no card through NVML")
    return [g["uuid"] for g in gpus]


def resolve_chips(args: argparse.Namespace, should_stop=None):
    """Returns (card ids, cleanup_fn_or_None)."""
    if args.backend == "static":
        return [c for c in args.chips.split(",") if c], None
    if args.backend == "alloc":
        from ..controller.kubestore import KubeStore
        from .allocation import ChipAllocator

        pool = [c for c in args.chips.split(",") if c]
        if not (args.api_base and args.node and pool and args.alloc_count > 0):
            raise RuntimeError(
                "alloc backend needs --api-base, --node, --chips (the node "
                "pool) and --alloc-count"
            )
        store = KubeStore(args.api_base, args.namespace, kinds=None)
        holder = args.pod_name or os.environ.get("POD_NAME") or f"req-{os.getpid()}"
        alloc = ChipAllocator(store, args.namespace, args.node, holder)
        try:
            chips = alloc.allocate(
                args.alloc_count,
                pool,
                timeout_s=args.alloc_timeout,
                should_stop=should_stop,
            )
        except Exception:
            alloc.release()  # never leak a partial/prior claim on failure
            raise
        return chips, alloc.release
    if args.backend == "env":
        from ..api import constants as C
        from ..parallel.topology import parse_gpu_map

        node = os.environ.get("NODE_NAME", "")
        path = args.chip_map_path or os.environ.get("CHIP_MAP_PATH", "")
        visible = os.environ.get(C.VISIBLE_DEVICES_ENV, "")
        if not (node and path and visible):
            raise RuntimeError(
                f"env backend needs NODE_NAME, CHIP_MAP_PATH and {C.VISIBLE_DEVICES_ENV}"
            )
        with open(path) as f:
            cards = parse_gpu_map(json.load(f)).get(node)
        if cards is None:
            raise RuntimeError(f"node {node} not in the gpu-map")
        want = {int(i) for i in visible.split(",")}
        return [uuid for uuid, index in cards if index in want], None
    return real_cards(), None


def memory_backend(args: argparse.Namespace, chip_ids: List[str]) -> Callable[[], Dict[str, int]]:
    if args.backend == "real":
        def usage() -> Dict[str, int]:
            from ..native import nvml

            return {u: m["used"] for u, m in nvml.memory_info(chip_ids).items()}

        return usage
    return lambda: {c: 0 for c in chip_ids}


async def serve(args: argparse.Namespace) -> None:
    # SIGTERM must run the cleanup path — the alloc backend's ConfigMap
    # claims are released on exit (gpu-allocation.go's defer-release
    # equivalent) — so install handlers BEFORE the allocation runs (which is
    # pushed to a thread below so the loop stays responsive to the signal).
    import signal

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass

    ready = ReadyFlag(False)
    sink = LogSink()
    # the alloc backend blocks (CAS polling up to --alloc-timeout): run it in
    # a thread so the installed SIGTERM handler can actually fire mid-wait
    alloc_task = asyncio.create_task(
        asyncio.to_thread(resolve_chips, args, stop.is_set)
    )
    stop_task = asyncio.create_task(stop.wait())
    done, _ = await asyncio.wait(
        {alloc_task, stop_task}, return_when=asyncio.FIRST_COMPLETED
    )
    if stop_task in done and alloc_task not in done:
        # terminated while waiting for cards: the allocator sees stop on its
        # next poll, releases anything it won, and raises
        try:
            await alloc_task
        except Exception:
            pass
        return
    stop_task.cancel()
    chips, cleanup = await alloc_task
    logger.info("requester stub: cards=%s", chips)
    apps = []
    try:
        spi = SpiServer(chips, ready, memory_backend(args, chips), sink)
        probes = ProbesServer(ready)
        for app, port in (
            (spi.build_app(), args.spi_port),
            (probes.build_app(), args.probes_port),
        ):
            await app.start(args.host, port)
            apps.append(app)
        logger.info("SPI on :%s, probes on :%s", args.spi_port, args.probes_port)
        await stop.wait()
    finally:
        # covers server-startup failures too: a claim must never outlive
        # the process that holds it
        for app in apps:
            await app.close()
        if cleanup is not None:
            cleanup()  # release ConfigMap card claims (alloc backend)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="fma-gpu-requester")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument(
        "--spi-port", type=int, default=int(os.environ.get("SPI_PORT", "8081"))
    )
    p.add_argument(
        "--probes-port",
        type=int,
        default=int(os.environ.get("PROBES_PORT", "8080")),
    )
    p.add_argument(
        "--backend", choices=("real", "env", "static", "alloc"), default="real"
    )
    p.add_argument(
        "--chips",
        default="",
        help="comma-separated card ids (static: owned outright; "
        "alloc: the node's contended pool)",
    )
    p.add_argument("--chip-map-path", default="", help="gpu-map file (env backend)")
    # alloc backend (ConfigMap-based contention emulation)
    p.add_argument("--api-base", default="", help="apiserver base URL")
    p.add_argument("--namespace", default="default")
    p.add_argument("--node", default=os.environ.get("NODE_NAME", ""))
    p.add_argument("--pod-name", default=os.environ.get("POD_NAME", ""))
    p.add_argument("--alloc-count", type=int, default=1)
    p.add_argument("--alloc-timeout", type=float, default=60.0)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    asyncio.run(serve(args))


if __name__ == "__main__":
    main()
