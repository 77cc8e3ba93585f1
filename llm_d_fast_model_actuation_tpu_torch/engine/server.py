"""A minimal engine HTTP server for the port, on the standard library.

Port of the first surface of ``llm_d_fast_model_actuation_tpu/engine/
server.py``: one engine thread fed by a submit queue, and the routes

  GET  /health, /is_sleeping, /v1/models
  POST /sleep?level=1|2, /wake_up, /v1/completions (token-id prompts,
       non-streaming)

with the reference's flag names for the flags it keeps, among them
``--packed-serving on|off``, ``--token-budget``, ``--attention-impl`` and
``--tensor-parallel-size N`` (one process drives the ``N`` ranks; with it
``--device`` takes a comma-separated list of ``N`` devices, which may name
one device more than once, and a single ``cuda`` means the first ``N``
cards).
The completion response has the reference's JSON keys; its ``text`` is
the reference's no-tokenizer (byte-level) decoding of the token ids. Not
ported yet, and answered with a 400 that says so: string prompts (they
need the tokenizer), ``stream``, ``echo``, ``logprobs``, string stops, and
the other routes of the reference (chat, metrics, swap, ...). Not ported
yet and absent from the options: the reference's other engine flags
(``--pipeline-decode``, ``--speculative-ngram``, ``--quantization``,
``--sleep-quant``, ``--resident-variants``, multi-host gangs, ...), also
where the reference combines them with tensor parallelism.

Run: ``python -m llm_d_fast_model_actuation_tpu_torch.engine.server
--model llama3-8b`` (on the card; ``--device cpu`` to run on the CPU;
``--tensor-parallel-size 2`` on two cards, or with ``--device
cuda:0,cuda:0`` as two ranks on one).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..models import llama
from ..ops.cuda.ragged import PAGE_SIZES
from ..parallel.mesh import serving_mesh
from .engine import ATTENTION_IMPLS, EngineConfig, InferenceEngine, validate_logit_bias
from .kv_cache import PageAllocator
from .sleep import attach_sleep, fresh_state

MODEL_CONFIGS = {
    "tiny": llama.LlamaConfig.tiny,
    "llama3-8b": llama.LlamaConfig.llama3_8b,
    "llama3-70b": llama.LlamaConfig.llama3_70b,
    "tiny-gemma": llama.LlamaConfig.tiny_gemma,
    "gemma3-4b": llama.LlamaConfig.gemma3_4b,
    "qwen2-7b": lambda: llama.LlamaConfig(
        vocab_size=152064,
        hidden_size=3584,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        intermediate_size=18944,
        rope_theta=1e6,
        max_seq_len=32768,
    ),
    "tinyllama-1.1b": lambda: llama.LlamaConfig(
        vocab_size=32000,
        hidden_size=2048,
        num_layers=22,
        num_heads=32,
        num_kv_heads=4,
        head_dim=64,
        intermediate_size=5632,
        rope_theta=10000.0,
        max_seq_len=2048,
    ),
    "bench-1b": lambda: llama.LlamaConfig(
        vocab_size=32000,
        hidden_size=2048,
        num_layers=24,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=5632,
        rope_theta=10000.0,
        max_seq_len=2048,
    ),
}

#: routes of the reference server this port does not serve yet
UNPORTED_ROUTES = (
    "/v1/chat/completions", "/metrics", "/v1/stats", "/v1/swap",
    "/v1/prefetch", "/v1/costs", "/v1/actuations", "/v1/parked",
    "/v1/residents", "/v1/traces",
)


def make_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fma-torch-engine", exit_on_error=False)
    p.add_argument("--model", default="tiny")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-model-len", type=int, default=0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--device", default="cuda",
        help="cuda (default) or cpu; with --tensor-parallel-size N > 1 also a "
        "comma-separated list of N devices, one per rank (a device may repeat: "
        "cuda:0,cuda:0), where a single cuda means the first N cards",
    )
    p.add_argument(
        "--tensor-parallel-size", type=int, default=1,
        help="shard the model and the KV cache over this many ranks, all "
        "driven by this one process",
    )
    p.add_argument(
        "--attention-impl", default="auto", choices=list(ATTENTION_IMPLS),
        help="decode cache-write strategy: reference = scatter-first, "
        "the others inline (auto = grouped); the kernels follow the device",
    )
    p.add_argument(
        "--packed-serving", choices=["on", "off"], default="off",
        help="token-packed mixed-batch serving: whenever prompt work is "
        "pending, one forward over a flat [token-budget] buffer packs "
        "prefill segments AND a decode row per running sequence (ragged "
        "paged attention). off (default) keeps the bucketed path",
    )
    p.add_argument(
        "--token-budget", type=int, default=0,
        help="row capacity of the packed buffer (--packed-serving). 0 = "
        "auto (256, floored so every decode slot plus one prefill block fits)",
    )
    return p


def parse_engine_options(options: str) -> argparse.Namespace:
    """Parse an options string; unknown flags and models raise ValueError."""
    try:
        args = make_arg_parser().parse_args(options.split())
    except (argparse.ArgumentError, SystemExit) as e:
        raise ValueError(f"invalid engine options {options!r}: {e}")
    check_engine_options(args)
    return args


def check_engine_options(args: argparse.Namespace) -> None:
    """The reference's checks of the options the port has; raises
    ValueError."""
    if args.model not in MODEL_CONFIGS:
        raise ValueError(f"unknown model {args.model!r}; known: {sorted(MODEL_CONFIGS)}")
    if args.token_budget < 0:
        raise ValueError("--token-budget must be >= 0, or 0 for auto")
    if args.tensor_parallel_size < 1:
        raise ValueError("--tensor-parallel-size must be >= 1")
    devices = args.device.split(",")
    if len(devices) > 1 and len(devices) != args.tensor_parallel_size:
        raise ValueError(
            f"--device names {len(devices)} devices for --tensor-parallel-size "
            f"{args.tensor_parallel_size}"
        )
    on_card = any(d.split(":")[0] != "cpu" for d in devices)
    if args.packed_serving == "on" and on_card and args.page_size not in PAGE_SIZES:
        raise ValueError(
            f"--packed-serving on takes --page-size in {PAGE_SIZES} on the card (the ragged "
            f"kernel's), got {args.page_size}"
        )


def mesh_from_options(args: argparse.Namespace):
    """The tensor-parallel mesh the options ask for; None for one rank. A
    device list is taken as given; a single ``cuda`` means the first N
    cards and raises when there are fewer; a single other device is every
    rank's."""
    tp = args.tensor_parallel_size
    if tp == 1:
        return None
    devices = args.device.split(",")
    if len(devices) == 1:
        devices = None if devices[0] == "cuda" else devices * tp
    return serving_mesh(tp, devices)


def byte_text(ids: List[int]) -> str:
    """The reference's no-tokenizer decoding (its ByteTokenizer)."""
    return bytes(t % 256 for t in ids).decode("utf-8", errors="replace")


class EngineService:
    """One engine plus its sleep manager, driven by one engine thread.
    The engine is built, and on one card has captured its chunk graphs,
    before the service takes a request.

    Requests enter through :meth:`submit` (any thread) and are resolved
    through futures. Sleep and wake are handed to the engine thread too
    and run between engine steps; while asleep the loop does not step and
    new requests wait."""

    def __init__(self, args: argparse.Namespace) -> None:
        self.args = args
        self.cfg = EngineConfig(
            model=MODEL_CONFIGS[args.model](),
            max_batch=args.max_batch,
            page_size=args.page_size,
            num_pages=args.num_pages,
            max_seq_len=args.max_model_len,
            attention_impl=args.attention_impl,
            packed_serving=args.packed_serving == "on",
            token_budget=args.token_budget,
        )
        mesh = mesh_from_options(args)
        self.engine = InferenceEngine(
            self.cfg, seed=args.seed, device=args.device if mesh is None else None, mesh=mesh
        )
        self.sleeper = attach_sleep(self.engine)
        self.failure: Optional[str] = None
        self._mu = threading.Lock()  # guards the two queues below
        self._pending: List[Tuple[Dict[str, Any], concurrent.futures.Future]] = []
        self._admin: List[Tuple[Any, concurrent.futures.Future]] = []
        self._futures: Dict[int, concurrent.futures.Future] = {}
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="engine", daemon=True)
        self._thread.start()

    # -- engine thread --------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._work.wait(timeout=0.5)
            self._work.clear()
            try:
                while not self._stop.is_set():
                    self._run_admin()
                    self._admit_pending()
                    if self.sleeper.is_sleeping or not self.engine.has_work():
                        break
                    for req in self.engine.step():
                        self._resolve(req)
            except Exception as e:  # noqa: BLE001 — the loop's boundary
                traceback.print_exc()
                with self._mu:
                    self.failure = f"{type(e).__name__}: {e}"
                self._fail_all(RuntimeError(self.failure))
                return

    def _run_admin(self) -> None:
        with self._mu:
            ops, self._admin = self._admin, []
        for fn, fut in ops:
            try:
                fut.set_result(fn())
            except Exception as e:  # noqa: BLE001 — reported to the caller
                fut.set_exception(e)

    def _admit_pending(self) -> None:
        with self._mu:
            batch, self._pending = self._pending, []
        for kw, fut in batch:
            try:
                sid = self.engine.add_request(**kw)
            except ValueError as e:
                fut.set_exception(e)
                continue
            self._futures[sid] = fut

    def _resolve(self, req) -> None:
        req.done_time = time.monotonic()
        fut = self._futures.pop(req.seq_id, None)
        if fut is None:
            return
        if req.error:
            fut.set_exception(RuntimeError(req.error))
        else:
            fut.set_result(req)

    def _fail_all(self, exc: BaseException) -> None:
        with self._mu:
            batch = self._pending + self._admin
            self._pending, self._admin = [], []
        for _, fut in batch:
            fut.set_exception(exc)
        for fut in self._futures.values():
            fut.set_exception(exc)
        self._futures.clear()

    def _on_loop(self, fn) -> Any:
        """Run ``fn`` on the engine thread between steps; wait for it."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._mu:
            if self.failure is not None:
                raise RuntimeError(self.failure)
            self._admin.append((fn, fut))
        self._work.set()
        return fut.result()

    # -- API ------------------------------------------------------------------

    def submit(self, **kw) -> concurrent.futures.Future:
        """Enqueue one request (``InferenceEngine.add_request`` keywords)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        kw.setdefault("submit_time", time.monotonic())
        with self._mu:
            if self.failure is not None:
                fut.set_exception(RuntimeError(self.failure))
                return fut
            self._pending.append((kw, fut))
        self._work.set()
        return fut

    def sleep(self, level: int) -> Dict[str, Any]:
        if level not in (1, 2):
            raise ValueError("sleep level must be 1 or 2")
        return self._on_loop(lambda: self.sleeper.sleep(level))

    def wake_up(self) -> Dict[str, Any]:
        def wake():
            if self.sleeper.level == 2:
                # the KV state is gone: fail whatever was mid-generation,
                # then rebuild weights and pool in place
                for req in self.engine.abort_all("level-2 sleep discarded state"):
                    self._resolve(req)
                return self.sleeper.wake_up(reinit=lambda: fresh_state(self.engine))
            return self.sleeper.wake_up()

        return self._on_loop(wake)

    def shutdown(self) -> None:
        self._stop.set()
        self._work.set()
        self._thread.join(timeout=30)


def _finish_reason(service: EngineService, req) -> str:
    if req.finish_reason:
        return req.finish_reason
    eos = service.engine.cfg.eos_token_id
    return "stop" if req.out_tokens and req.out_tokens[-1] == eos else "length"


def _lifecycle_usage(req) -> Dict[str, Any]:
    """The reference's per-request usage extras: queue wait and decode
    TPOT."""
    qw = None
    if req.first_sched_time is not None:
        qw = max(0.0, req.first_sched_time - req.submit_time)
    tpot = None
    n = len(req.out_tokens)
    if req.first_token_time is not None and req.done_time is not None and n > 1:
        tpot = max(0.0, (req.done_time - req.first_token_time) / (n - 1))
    return {"queue_wait_s": qw, "decode_tpot_s": tpot}


class BadRequest(ValueError):
    """A client error: answered with HTTP 400 and this message."""


def parse_completion(service: EngineService, body: Any) -> Tuple[Dict[str, Any], int]:
    """Validate a /v1/completions body into add_request keywords and n;
    everything add_request would reject is a BadRequest here."""
    if not isinstance(body, dict):
        raise BadRequest("request body must be a JSON object")
    for key, what in (("stream", "streaming"), ("echo", "echo"), ("logprobs", "logprobs")):
        if body.get(key):
            raise BadRequest(f"{what} is not supported by this server yet")
    prompt = body.get("prompt")
    if isinstance(prompt, str):
        raise BadRequest("string prompts need a tokenizer, which this server does not have yet; send token ids")
    if not isinstance(prompt, list) or not all(isinstance(t, int) and not isinstance(t, bool) for t in prompt):
        raise BadRequest("prompt must be a list of token ids")
    vocab = service.cfg.model.vocab_size
    tokens = [t % vocab for t in prompt]
    if not tokens:
        raise BadRequest("empty prompt")
    try:
        mt = body.get("max_tokens")
        max_tokens = 16 if mt is None else int(mt)
        tv = body.get("temperature")
        temperature = 0.0 if tv is None else float(tv)
        top_p = float(1.0 if body.get("top_p") is None else body.get("top_p"))
        pp, fp = body.get("presence_penalty"), body.get("frequency_penalty")
        presence = 0.0 if pp is None else float(pp)
        frequency = 0.0 if fp is None else float(fp)
        n = 1 if body.get("n") is None else int(body.get("n"))
    except (TypeError, ValueError) as e:
        raise BadRequest(f"invalid generation parameter: {e}")
    if max_tokens < 1:
        raise BadRequest(f"max_tokens must be >= 1, got {max_tokens}")
    if not (0.0 < top_p <= 1.0):
        raise BadRequest(f"top_p must be in (0, 1], got {top_p}")
    for name, v in (("presence_penalty", presence), ("frequency_penalty", frequency)):
        if not (-2.0 <= v <= 2.0):
            raise BadRequest(f"{name} must be in [-2, 2], got {v}")
    if not (1 <= n <= service.cfg.max_batch):
        raise BadRequest(f"n must be in 1..{service.cfg.max_batch}")
    seed = body.get("seed")
    if seed is not None and (isinstance(seed, bool) or not isinstance(seed, int) or not (-(2**63) <= seed < 2**63)):
        raise BadRequest("seed must be an integer that fits in a signed 64-bit integer")
    iev = body.get("ignore_eos")
    if iev is not None and not isinstance(iev, bool):
        raise BadRequest(f"ignore_eos must be a bool, got {iev!r}")
    try:
        logit_bias = validate_logit_bias(body.get("logit_bias"), vocab)
    except ValueError as e:
        raise BadRequest(str(e))
    stop = body.get("stop")
    stop_seqs: List[Tuple[int, ...]] = []
    if stop is not None:
        if isinstance(stop, str) or not isinstance(stop, list):
            raise BadRequest("string stops need a tokenizer; stop must be a list of token ids or token-id lists")
        for s in stop:
            if isinstance(s, int) and not isinstance(s, bool):
                stop_seqs.append((s % vocab,))
            elif isinstance(s, list) and s and all(isinstance(t, int) for t in s):
                stop_seqs.append(tuple(t % vocab for t in s))
            else:
                raise BadRequest(f"invalid stop entry {s!r} (token ids only)")
    cfg = service.cfg
    if len(tokens) + max_tokens > cfg.seq_len:
        raise BadRequest(
            f"prompt+generation {len(tokens)}+{max_tokens} exceeds max_seq_len {cfg.seq_len}"
        )
    need = PageAllocator.pages_needed(len(tokens) + max_tokens, cfg.page_size)
    if need > cfg.num_pages - 1:
        raise BadRequest(f"request needs {need} pages but the pool only has {cfg.num_pages - 1}")
    kw = dict(
        prompt=tokens, max_new_tokens=max_tokens, temperature=temperature,
        top_p=top_p, stop_seqs=tuple(stop_seqs), presence_penalty=presence,
        frequency_penalty=frequency, seed=seed, ignore_eos=bool(iev),
        logit_bias=logit_bias,
    )
    return kw, n


def completion_response(service: EngineService, body: Dict[str, Any], reqs) -> Dict[str, Any]:
    req = reqs[0]
    ttft = (req.first_token_time - req.submit_time) if req.first_token_time else None
    choices = []
    for i, r in enumerate(reqs):
        choices.append({
            "index": i,
            "token_ids": list(r.out_tokens),
            "text": byte_text(r.out_tokens),
            "finish_reason": _finish_reason(service, r),
        })
    return {
        "object": "text_completion",
        "model": body.get("model") or service.args.model,
        "choices": choices,
        "usage": {
            "prompt_tokens": len(req.prompt),
            "completion_tokens": sum(len(r.out_tokens) for r in reqs),
            "time_to_first_token_s": ttft,
            **_lifecycle_usage(req),
        },
    }


def make_handler(service: EngineService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # keep stdout for the caller
            pass

        def _send(self, status: int, obj: Any) -> None:
            data = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> Any:
            n = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(n) if n else b""
            try:
                return json.loads(raw or b"{}")
            except ValueError:
                raise BadRequest("invalid JSON body")

        def _route(self, method: str) -> None:
            url = urlparse(self.path)
            path = url.path.rstrip("/") or "/"
            try:
                if method == "POST":
                    # always read the body, so the connection stays usable
                    body = self._body()
                if path in UNPORTED_ROUTES:
                    raise BadRequest(f"{path} is not supported by this server yet")
                if method == "GET" and path == "/health":
                    if service.failure is not None:
                        return self._send(503, {"status": "FAILED", "error": service.failure})
                    return self._send(200, {"status": "OK"})
                if method == "GET" and path == "/is_sleeping":
                    return self._send(200, {
                        "is_sleeping": service.sleeper.is_sleeping,
                        "devices_released": service.sleeper.devices_released,
                    })
                if method == "GET" and path == "/v1/models":
                    return self._send(200, {"object": "list", "data": [{"id": service.args.model, "object": "model"}]})
                if method == "POST" and path == "/sleep":
                    try:
                        level = int(parse_qs(url.query).get("level", ["1"])[0])
                        return self._send(200, service.sleep(level))
                    except ValueError as e:
                        raise BadRequest(str(e))
                if method == "POST" and path == "/wake_up":
                    return self._send(200, service.wake_up())
                if method == "POST" and path == "/v1/completions":
                    kw, n = parse_completion(service, body)
                    futs = [service.submit(**kw) for _ in range(n)]
                    try:
                        reqs = [f.result() for f in futs]
                    except ValueError as e:
                        raise BadRequest(str(e))
                    except RuntimeError as e:
                        return self._send(500, {"error": str(e)})
                    return self._send(200, completion_response(service, body, reqs))
                return self._send(404, {"error": f"no route {method} {path}"})
            except BadRequest as e:
                return self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the request's boundary
                return self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def do_GET(self):
            self._route("GET")

        def do_POST(self):
            self._route("POST")

    return Handler


def serve(service: EngineService, host: str, port: int) -> ThreadingHTTPServer:
    """Start the HTTP server on a background thread; ``port`` 0 picks a
    free port (``server.server_address`` has it). Stop with
    ``server.shutdown()``."""
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, name="http", daemon=True).start()
    return server


def main(argv: Optional[List[str]] = None) -> None:
    args = make_arg_parser().parse_args(argv)
    try:
        check_engine_options(args)
    except ValueError as e:
        raise SystemExit(str(e))
    service = EngineService(args)  # the engine captures its chunk graphs here
    server = serve(service, args.host, args.port)
    eng = service.engine
    print(
        f"serving {args.model} on http://{args.host}:{server.server_address[1]} "
        f"(capture_s={eng.capture_s:.3f} graph_captures={eng.graph_captures} "
        f"mapped_bytes={sum(a.mapped_bytes for a in eng.arenas.values())})",
        flush=True,
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.shutdown()


if __name__ == "__main__":
    main()
