"""Launcher CLI: preload, then serve the instance-management REST API.

The port of the JAX package's ``launcher/main.py``, with its flags. Run
on a machine with NVIDIA cards:

    python -m llm_d_fast_model_actuation_tpu_torch.launcher.main --port 8001

or without cards, with mock ids, children on the CPU (their options say
``--device cpu``):

    python -m llm_d_fast_model_actuation_tpu_torch.launcher.main --mock-chips

In real mode the launcher first builds the kernels from ``csrc/`` (nvcc
only, no CUDA context), with or without preload, so no child compiles.
This is the counterpart of the JAX launcher's shared XLA compile cache; a
failed build stops the launcher. Preloading then imports torch and the
port's engine modules into the fork server every engine child is forked
from (``instance.py``), so a child starts with warm modules; with
``--no-preload`` each child imports them itself. Neither the launcher nor its fork server
ever touches ``torch.cuda``: a process that has initialized CUDA cannot
hand a working CUDA to a child forked from it.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal

logger = logging.getLogger(__name__)

#: what the fork server imports before it forks any child
PRELOAD_MODULES = (
    "torch",
    "llm_d_fast_model_actuation_tpu_torch.engine.server",
    "llm_d_fast_model_actuation_tpu_torch.models.llama",
)


def build_kernels() -> None:
    """Build every kernel library the children load (real mode), into
    ``FMA_KERNEL_BUILD_DIR`` when set, else the checkout's
    ``build/kernels/``."""
    from ..ops.cuda import build

    built = build.build_all()
    logger.info("kernels ready in %s: %s", build.build_dir(), sorted(built))


def preload() -> None:
    """Import the heavy modules once, here and in the fork server. Starts
    the fork server and waits for its imports."""
    import torch

    from ..engine import server as _server  # noqa: F401  (engine modules warm)
    from ..models import llama as _llama  # noqa: F401

    start_fork_server(PRELOAD_MODULES)
    logger.info("preloaded torch %s", torch.__version__)


def start_fork_server(modules=()) -> None:
    """Start the fork server the children come from, importing
    ``modules`` first, and wait until it has: it answers a fork request
    only after its imports, so one empty child (``int()``) is started and
    joined here, and the first create pays none of them. With no modules
    (``--no-preload``) every child imports what it needs itself."""
    from .instance import CONTEXT

    CONTEXT.set_forkserver_preload(list(modules))
    child = CONTEXT.Process(target=int)
    child.start()
    child.join()


def make_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fma-torch-launcher")
    p.add_argument("--host", default="0.0.0.0")
    # FMA_LAUNCHER_PORT: the dual-pods controller injects this when a
    # hostNetwork node already has a launcher on the default port
    p.add_argument(
        "--port",
        type=int,
        default=int(os.environ.get("FMA_LAUNCHER_PORT", "8001")),
    )
    p.add_argument("--log-level", default="info")
    p.add_argument("--mock-chips", action="store_true")
    p.add_argument("--mock-chip-count", type=int, default=8)
    p.add_argument("--mock-topology", default="", help="shapes the naive mock's ids only")
    p.add_argument("--chip-map-path", default="")
    p.add_argument("--log-dir", default="")
    p.add_argument(
        "--compile-cache-dir", default="",
        help="where real mode builds the kernels every child loads (default: "
        "the checkout's build/kernels)",
    )
    p.add_argument("--no-preload", action="store_true")
    p.add_argument(
        "--restart-budget",
        type=int,
        default=int(os.environ.get("FMA_RESTART_BUDGET", "0")),
        help="supervised restarts per crash loop for a crashed engine "
        "child (0 = report-only); a child that stays up past the reset "
        "window earns its budget back",
    )
    p.add_argument(
        "--restart-backoff",
        type=float,
        default=0.5,
        help="first restart delay (s); doubles per attempt with jitter",
    )
    p.add_argument(
        "--restart-backoff-max",
        type=float,
        default=30.0,
        help="backoff ceiling (s) for supervised restarts",
    )
    p.add_argument(
        "--restart-reset-window",
        type=float,
        default=300.0,
        help="uptime (s) after which a restarted child's crash counter "
        "resets (budget bounds crash loops, not lifetime restarts)",
    )
    p.add_argument(
        "--notify-pod",
        action="store_true",
        help="run the state-change reflector in-process: patch the launcher "
        "Pod's instance-signature annotation on every instance state change "
        "(needs POD_NAME/NAMESPACE)",
    )
    return p


def main(argv=None) -> None:
    p = make_arg_parser()
    args = p.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(), logging.INFO))
    if args.notify_pod and not (os.environ.get("POD_NAME") and os.environ.get("NAMESPACE")):
        p.error("--notify-pod needs POD_NAME and NAMESPACE env (Downward API)")

    from .chiptranslator import ChipTranslator
    from .manager import EngineProcessManager, RestartPolicy
    from .rest import LauncherApp

    translator = ChipTranslator.create(
        mock_chips=args.mock_chips,
        mock_chip_count=args.mock_chip_count,
        mock_topology=args.mock_topology,
        chip_map_path=args.chip_map_path or None,
    )
    if args.compile_cache_dir:
        # set before the fork server starts: every child inherits it
        os.environ["FMA_KERNEL_BUILD_DIR"] = args.compile_cache_dir
    if not args.mock_chips:
        build_kernels()
    if args.no_preload:
        start_fork_server()
    else:
        preload()
    restart_policy = None
    if args.restart_budget > 0:
        restart_policy = RestartPolicy(
            budget=args.restart_budget,
            backoff_s=args.restart_backoff,
            backoff_max_s=args.restart_backoff_max,
            reset_window_s=args.restart_reset_window,
        )
    manager = EngineProcessManager(
        translator, log_dir=args.log_dir, restart_policy=restart_policy
    )
    app = LauncherApp(manager)
    asyncio.run(_serve(app, manager, args, len(translator.chip_ids()), translator.mode))


async def _serve(app, manager, args, n_chips: int, mode: str) -> None:
    """Serve until SIGTERM or SIGINT, then close the server and stop every
    instance."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    port = await app.start(args.host, args.port)
    notifier = task = None
    if args.notify_pod:
        from .notifier import InstanceStateNotifier, kubectl_patcher

        async def lister():
            return manager.get_all_instances_status().get("instances", [])

        async def watcher(since_revision: int):
            # cursor = since_revision (tracked by the notifier), so events
            # published between connect and first read are replayed
            return manager.broadcaster.subscribe(since_revision=since_revision)

        notifier = InstanceStateNotifier(
            lister, kubectl_patcher(os.environ["POD_NAME"], os.environ["NAMESPACE"]), watcher=watcher
        )
        task = loop.create_task(notifier.run())
    logger.info("launcher serving on %s:%s (%s chips, mode %s)", args.host, port, n_chips, mode)
    try:
        await stop.wait()
    finally:
        if notifier is not None:
            notifier.stop()
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        await app.close()


if __name__ == "__main__":
    main()
