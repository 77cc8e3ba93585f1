#!/usr/bin/env python3
"""What a build's graph captures cost beside the work that overlaps them,
on one full-width Llama-3-8B engine (random weights from seed 0, 2048
pages), on one card.

Usage, from the root of a checkout, on a machine with one card:

    python3 capture_overlap.py [--rounds 2] [--parts recapture,builds,threads]

Three parts (the first two by default), each in turns:

* ``recapture``: the engine's four chunk captures alone and beside the
  weights' digest job at 8 and at 4 threads. Each condition releases the
  graphs and captures them again (``InferenceEngine.on_reacquire``, on the
  calling thread); the digest job (``chunk_store.DigestJob``) hashes the
  engine's 16 GB of weights from the card and starts just before the
  captures.
* ``builds``: whole engine builds in two orders. ``beside``: the captures
  on a thread of their own while the weights are written (on a stream of
  their own), then joined; ``after``: the weights written, then the
  captures on the building thread. Each order builds from a checkpoint on
  the local disk (written once from the seeded weights, in Llama-3-8B's
  published layout; ``hf.load_params``, then the digest job started as
  the service starts it) and from its staged host tree in pinned memory
  (``load_params(place=False)``, then ``place_staged_params``: a
  prefetched swap's build). Each build's captures are broken down into
  the eager warm-up runs, the captured bodies, the instantiations, the
  reading of the kernel nodes and the cache releases.
* ``threads``: the same host work on the main thread, on a new thread
  each time and on one long-lived thread: a Python loop, 20,000 small
  launches, an eager chunk, and a re-capture with the capturing thread's
  CPU seconds (the engine pads the malloc heaps first:
  ``graphs.pad_malloc_heaps``).

Prints one JSON line per measurement and a summary line with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


class Breakdown:
    """Seconds spent in the pieces of a capture, on any thread, summed."""

    PARTS = ("eager_s", "body_s", "instantiate_s", "nodes_s", "release_s")

    def __init__(self) -> None:
        self.mu = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.secs = {k: 0.0 for k in self.PARTS}

    def wrap(self, owner, name: str, part: str) -> None:
        real = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.monotonic()
            try:
                return real(*a, **kw)
            finally:
                with self.mu:
                    self.secs[part] += time.monotonic() - t0

        setattr(owner, name, timed)

    def take(self) -> dict:
        out = {k: round(v, 6) for k, v in self.secs.items()}
        self.reset()
        return out


def instrument(torch, parts: Breakdown) -> None:
    from llm_d_fast_model_actuation_tpu_torch.engine import graphs
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import InferenceEngine

    # chunk_eager calls chunk_body: the eager runs' body seconds are
    # taken back out in summary()
    parts.wrap(InferenceEngine, "chunk_eager", "eager_s")
    parts.wrap(InferenceEngine, "chunk_body", "body_s")
    parts.wrap(torch.cuda.CUDAGraph, "instantiate", "instantiate_s")
    parts.wrap(graphs, "kernel_nodes", "nodes_s")
    parts.wrap(graphs, "release_cached_memory", "release_s")


def build_order(order: str, after_load):
    """``InferenceEngine._build`` in one of the two orders; ``after_load``
    runs right after the weights are written (the digest job's start)."""
    import torch

    def build(self, params, warmup_buckets) -> None:
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        t0 = time.monotonic()
        box: dict = {}

        def capture():
            try:
                box["capture_s"] = self.graphs.capture()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["error"] = e

        worker = threading.Thread(target=capture, name="capture") if order == "beside" else None
        if worker is not None:
            worker.start()
        with torch.cuda.stream(stream):
            self._write_params(params)
        stream.synchronize()
        t1 = time.monotonic()
        after_load(self)
        if worker is None:
            capture()
        else:
            worker.join()
        if "error" in box:
            raise box["error"]
        with torch.no_grad():
            for t in self.pool.tensors():
                t[:, 0].zero_()
        self._dirty = True
        self.capture_s = box["capture_s"]
        self.warmup_stats = {"load_s": t1 - t0, "capture_s": box["capture_s"]}

    return build


def recapture_part(torch, eng, rounds: int, parts: Breakdown) -> list:
    from llm_d_fast_model_actuation_tpu_torch.engine.chunk_store import DigestJob
    from llm_d_fast_model_actuation_tpu_torch.models import hf

    leaves = hf.model_leaves(eng.model)
    rows = []
    for r in range(rounds):
        for workers in ((0, 8, 4) if r % 2 == 0 else (4, 8, 0)):
            eng.graphs.release()
            parts.take()
            job = DigestJob(leaves, workers=workers) if workers else None
            t0 = time.monotonic()
            capture_s = eng.on_reacquire()
            digest_s = None
            if job is not None:
                job.result()
                digest_s = job.seconds
            row = {"part": "recapture", "round": r, "digest_workers": workers, "capture_s": capture_s,
                   "digest_s": digest_s, "wall_s": time.monotonic() - t0, **parts.take()}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def threads_part(torch, eng, rounds: int, parts: Breakdown) -> list:
    """The same host work on the main thread, on a new thread each time
    and on one long-lived thread: a Python loop, 20,000 small launches, an
    eager chunk, and a re-capture with its thread CPU seconds."""
    import queue

    small = torch.zeros(16, device=eng.device)

    def work() -> dict:
        out = {"thread": threading.current_thread().name, "cpus": len(os.sched_getaffinity(0))}
        t0, x = time.monotonic(), 0
        for i in range(2_000_000):
            x += i
        out["python_loop_s"] = time.monotonic() - t0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(20_000):
            small.add_(1)
        torch.cuda.synchronize()
        out["launch_20k_s"] = time.monotonic() - t0
        with torch.no_grad():
            t0 = time.monotonic()
            eng.chunk_eager(8, False)
            torch.cuda.synchronize()
            out["eager_chunk_s"] = time.monotonic() - t0
        eng.graphs.release()
        parts.take()
        c0 = time.thread_time()
        out["capture_s"] = eng.on_reacquire()
        out["capture_thread_cpu_s"] = time.thread_time() - c0
        out.update(parts.take())
        return out

    def on_new_thread() -> dict:
        box: dict = {}
        t = threading.Thread(target=lambda: box.update(work()), name="new")
        t.start()
        t.join()
        return box

    jobs: "queue.Queue" = queue.Queue()
    done: "queue.Queue" = queue.Queue()

    def serve() -> None:
        while True:
            fn = jobs.get()
            if fn is None:
                return
            done.put(fn())

    kept = threading.Thread(target=serve, name="kept", daemon=True)
    kept.start()

    def on_kept_thread() -> dict:
        jobs.put(work)
        return done.get()

    rows = []
    try:
        for r in range(rounds):
            order = (("main", work), ("new", on_new_thread), ("kept", on_kept_thread))
            for where, fn in (order if r % 2 == 0 else order[::-1]):
                row = {"part": "threads", "round": r, "where": where, **fn()}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        jobs.put(None)
        kept.join()
    return rows


def builds_part(torch, cfg, ckpt: str, rounds: int, parts: Breakdown) -> list:
    from llm_d_fast_model_actuation_tpu_torch.engine import graphs
    from llm_d_fast_model_actuation_tpu_torch.engine.chunk_store import DigestJob
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import InferenceEngine
    from llm_d_fast_model_actuation_tpu_torch.models import hf

    t0 = time.monotonic()
    staged = hf.load_params(ckpt, cfg.model, place=False)
    stage_s = time.monotonic() - t0
    print(json.dumps({"part": "staged", "stage_s": stage_s}), flush=True)
    real_build = InferenceEngine._build
    rows = []
    try:
        for r in range(rounds):
            for order in (("beside", "after") if r % 2 == 0 else ("after", "beside")):
                for source in ("disk", "staged"):
                    jobs = []

                    def after_load(eng, source=source):
                        if source == "disk":
                            jobs.append(DigestJob(hf.model_leaves(eng.model)))

                    if source == "disk":
                        def params(model):
                            hf.load_params(ckpt, model)
                    else:
                        def params(model):
                            hf.place_staged_params(staged, model)
                    InferenceEngine._build = build_order(order, after_load)
                    parts.take()
                    t0 = time.monotonic()
                    eng = InferenceEngine(cfg, params=params, device="cuda")
                    build_s = time.monotonic() - t0
                    digest_wait_s = digest_s = None
                    if jobs:
                        t1 = time.monotonic()
                        jobs[0].result()
                        digest_wait_s, digest_s = time.monotonic() - t1, jobs[0].seconds
                    row = {"part": "builds", "round": r, "order": order, "source": source, "build_s": build_s,
                           "load_s": eng.warmup_stats["load_s"], "capture_s": eng.capture_s,
                           "digest_s": digest_s, "digest_wait_after_build_s": digest_wait_s,
                           "graph_captures": eng.graph_captures, **parts.take()}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                    eng.graphs.release()
                    del eng
                    gc.collect()
                    graphs.release_cached_memory(torch.device("cuda", 0))
    finally:
        InferenceEngine._build = real_build
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("capture_overlap: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from llm_d_fast_model_actuation_tpu_torch.engine.engine import EngineConfig, InferenceEngine
    from llm_d_fast_model_actuation_tpu_torch.models.llama import LlamaConfig
    from llm_d_fast_model_actuation_tpu_torch.ops.cuda import build

    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--parts", default="recapture,builds", help="comma-separated: recapture, builds, threads")
    args = p.parse_args()
    wanted = set(args.parts.split(","))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    build.build_all()
    parts = Breakdown()
    instrument(torch, parts)
    cfg = EngineConfig(model=LlamaConfig.llama3_8b(), num_pages=2048)
    eng = InferenceEngine(cfg, device="cuda")
    thr = threads_part(torch, eng, args.rounds, parts) if "threads" in wanted else []
    rec = recapture_part(torch, eng, args.rounds, parts) if "recapture" in wanted else []
    blds = []
    if "builds" in wanted:
        ckpt = chip_smoke.checkpoint_dir(17 << 30)
        try:
            written = chip_smoke.write_hf_checkpoint(torch, eng.model, ckpt)
            print(json.dumps({"part": "checkpoint", **written}), flush=True)
            eng.graphs.release()
            del eng
            gc.collect()
            blds = builds_part(torch, cfg, ckpt, args.rounds, parts)
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
    summary = {"recapture": {}, "builds": {}, "threads": {}}
    for where in ("main", "new", "kept"):
        got = [row for row in thr if row["where"] == where]
        summary["threads"][where] = {k: [round(row[k], 3) for row in got]
                                     for k in ("python_loop_s", "launch_20k_s", "eager_chunk_s", "capture_s",
                                               "capture_thread_cpu_s")}
    for workers in (0, 8, 4) if rec else ():
        got = [row for row in rec if row["digest_workers"] == workers]
        summary["recapture"][str(workers)] = {k: [row[k] for row in got] for k in ("capture_s", "digest_s")}
    for order in ("beside", "after"):
        for source in ("disk", "staged"):
            got = [row for row in blds if row["order"] == order and row["source"] == source]
            if got:
                summary["builds"][f"{order}/{source}"] = {k: [round(row[k], 3) for row in got]
                                                          for k in ("build_s", "load_s", "capture_s")}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
