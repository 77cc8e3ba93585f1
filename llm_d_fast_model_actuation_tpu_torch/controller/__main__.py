"""Control-plane CLI: `python -m llm_d_fast_model_actuation_tpu_torch.controller`.

The port of the JAX package's ``controller/__main__.py``. Subcommands
mirror the reference's two controller binaries
(cmd/dual-pods-controller/main.go:40-119, cmd/launcher-populator/
main.go:42-140) and the chart's args (deploy/chart). The cluster store
backend is selected by --store:

  memory  — in-process store (demo / single-process integration runs; the
            launcher/requester/engine transports are still real HTTP)
  kube    — list+watch informer cache + REST writes against a
            kube-apiserver (kubestore.KubeStore): in-cluster service-account
            wiring by default, or --kube-api-url/--kube-token-file for an
            explicit endpoint.

For example, against an apiserver reachable on localhost, with the
reference's sleeping budget of one sleeper (4096 MiB):

    python -m llm_d_fast_model_actuation_tpu_torch.controller dual-pods-controller \\
        --namespace default --kube-api-url http://127.0.0.1:8080 \\
        --accelerator-sleeping-memory-limit-bytes 4294967296

The dual-pods controller runs the slice-gang coordinator beside it
(``controller/gang.py``: an ISC asking for more than one host is served by
a gang of engine processes, one per node) unless ``--disable-slice-gangs``
is given, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import asyncio
import logging


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--namespace", required=True, help="namespace to watch (controllers are namespace-scoped)")
    p.add_argument("--store", choices=["memory", "kube"], default="kube")
    p.add_argument("--kube-api-url", default="", help="apiserver URL (default: in-cluster)")
    p.add_argument("--kube-token-file", default="", help="bearer token file (with --kube-api-url)")
    p.add_argument("--kube-ca-file", default="", help="CA bundle (with --kube-api-url)")
    p.add_argument("--metrics-port", type=int, default=8002)
    p.add_argument("--log-level", default="info")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="fma-gpu-controllers")
    sub = p.add_subparsers(dest="cmd", required=True)

    dpc = sub.add_parser("dual-pods-controller", help="bind requesters to providers")
    _common(dpc)
    dpc.add_argument("--sleeper-limit", type=int, default=1)
    dpc.add_argument("--accelerator-sleeping-memory-limit-bytes", type=int, default=0)
    dpc.add_argument(
        "--disable-slice-gangs",
        action="store_true",
        help="don't run the slice-gang coordinator (multi-host ISCs will never actuate)",
    )

    pop = sub.add_parser("launcher-populator", help="proactive launcher population")
    _common(pop)
    pop.add_argument("--expectation-timeout", type=float, default=5.0)
    pop.add_argument("--stuck-scheduling-threshold", type=float, default=120.0)
    pop.add_argument("--stuck-starting-threshold", type=float, default=450.0)

    args = p.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper(), logging.INFO))

    from .metrics import serve_metrics

    if args.store == "kube":
        from .kubestore import KubeStore

        if args.kube_api_url:
            store = KubeStore(
                args.kube_api_url,
                args.namespace,
                # pass the FILE: bound SA tokens rotate, KubeStore re-reads
                # per request
                token_file=args.kube_token_file or None,
                ca_file=args.kube_ca_file or None,
            )
        else:
            try:
                store = KubeStore.in_cluster(args.namespace)
            except (KeyError, OSError) as e:
                p.error(
                    f"not running in-cluster ({e}); pass --kube-api-url or "
                    "--store=memory"
                )
    else:
        from .store import InMemoryStore

        store = InMemoryStore()
    serve_metrics(args.metrics_port)

    async def run() -> None:
        if hasattr(store, "start"):
            await store.start()
        gang = None
        if args.cmd == "dual-pods-controller":
            from .clients import HttpTransports
            from .dualpods import DualPodsConfig, DualPodsController

            ctl = DualPodsController(
                store,
                HttpTransports(),
                DualPodsConfig(
                    namespace=args.namespace,
                    sleeper_limit=args.sleeper_limit,
                    accelerator_sleeping_memory_limit_bytes=args.accelerator_sleeping_memory_limit_bytes,
                ),
            )
            if not args.disable_slice_gangs:
                from .gang import SliceGangCoordinator

                gang = SliceGangCoordinator(store, args.namespace)
        else:
            from .populator import Populator, PopulatorConfig

            ctl = Populator(
                store,
                PopulatorConfig(
                    namespace=args.namespace,
                    expectation_timeout_s=args.expectation_timeout,
                    stuck_scheduling_threshold_s=args.stuck_scheduling_threshold,
                    stuck_starting_threshold_s=args.stuck_starting_threshold,
                ),
            )
        await ctl.start()
        if gang is not None:
            await gang.start()
        # readiness = initial batch processed (knows-processed-sync):
        # destructive decisions are safe only after one pass over the world
        await ctl.initial_sync.wait()
        logging.getLogger(__name__).info(
            "initial batch processed; controller ready"
        )
        try:
            await asyncio.Event().wait()  # serve forever
        finally:
            if gang is not None:
                await gang.stop()
            await ctl.stop()
            if hasattr(store, "stop"):
                await store.stop()

    asyncio.run(run())


if __name__ == "__main__":
    main()
