"""Probes server: /ready -> 200/503 from the controller-set readiness bool
(reference: pkg/server/requester/probes/server.go:38-87), the port of the
JAX package's ``requester/probes.py`` on asyncio streams. This is what the
kubelet's readiness probe hits, turning controller relays into Pod Ready
condition flips that HPA/EPP/users observe."""

from __future__ import annotations

from ..api import spi as spiapi
from ..launcher.http11 import App, Request, Response, text_response
from .spi import ReadyFlag


class ProbesServer:
    def __init__(self, ready_flag: ReadyFlag) -> None:
        self.ready = ready_flag

    def build_app(self) -> App:
        async def ready(request: Request) -> Response:
            if self.ready.get():
                return text_response("ready\n")
            return text_response("not ready\n", 503)

        return App([("GET", spiapi.READY_PATH, ready)])
