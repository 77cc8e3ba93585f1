"""One member of the port's two-process gang (tests/test_torch_multihost_e2e.py).

Usage: torch_gang_worker.py <process_id> <num_processes> <coordinator_port>
<weights.npz> [mode]

Every member builds the same EngineService (the tiny Llama at fp32, tp 2,
``--device cpu``), its weights the JAX package's parameters saved in
``weights.npz`` and carried over by ``models/convert.py``, as a real gang's
members run identical options. Process 0 leads and drives the traffic of
tests/gang_worker.py; the follower replays the leader's frames. The leader
prints the lines the test reads (:func:`traffic`).

Modes: ``normal`` (the traffic, a level-1 cycle and a clean shutdown),
``serve-wait`` (one request, then idle until killed) and ``idle`` (the
exchanges' group timeout cut to 2 s; one request, an idle spell past it,
another request).

``torch_gang_worker.py mesh <process_id> <coordinator_port> <tp> <out.pt>``
runs the mesh's collectives alone (:func:`mesh_collectives`).
"""

import dataclasses
import datetime
import sys
import time

import numpy as np
import torch

OPTIONS = ("--model tiny --num-pages 32 --page-size 8 --max-batch 2 --max-model-len 64 --tensor-parallel-size 2 "
           "--decode-chunk 4 --max-prefill-tokens 8")


def load_tree(path: str) -> dict:
    """The JAX parameter tree a test saved with :func:`save_tree`."""
    flat = np.load(path)
    tree: dict = {"layers": {}}
    for k in flat.files:
        if k.startswith("layers."):
            tree["layers"][k[len("layers."):]] = flat[k]
        else:
            tree[k] = flat[k]
    return tree


def save_tree(tree: dict, path: str) -> None:
    flat = {f"layers.{k}": v for k, v in tree["layers"].items()}
    flat.update({k: v for k, v in tree.items() if k != "layers"})
    np.savez(path, **flat)


def carry(tree: dict, monkeypatch=None) -> None:
    """Make the server build the tiny model at fp32 with ``tree``'s weights
    (through ``monkeypatch`` when a test gives one, so it is undone)."""
    from llm_d_fast_model_actuation_tpu_torch.engine import server
    from llm_d_fast_model_actuation_tpu_torch.models import llama
    from llm_d_fast_model_actuation_tpu_torch.models.convert import params_from_jax

    base = server.InferenceEngine

    class Carried(base):
        def __init__(self, cfg, params=None, seed=0, device=None, mesh=None, warmup_buckets=()):
            if params is None:
                params = params_from_jax(tree, device or "cpu", mesh=mesh, cfg=cfg.model)
            super().__init__(cfg, params=params, seed=seed, device=device, mesh=mesh, warmup_buckets=warmup_buckets)

    def tiny():
        return dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)

    if monkeypatch is None:
        server.MODEL_CONFIGS["tiny"] = tiny
        server.InferenceEngine = Carried
    else:
        monkeypatch.setitem(server.MODEL_CONFIGS, "tiny", tiny)
        monkeypatch.setattr(server, "InferenceEngine", Carried)


def traffic(svc, say) -> None:
    """The leader's traffic: tests/gang_worker.py's, its tokens said."""

    def run(prompt, n):
        return svc.submit(prompt=prompt, max_new_tokens=n, temperature=0.0).result(timeout=60).out_tokens

    out1 = run([5, 6, 7], 6)
    say("OUT1", out1)
    # a second, batched round: the chunk re-uploads at its edges
    f1 = svc.submit(prompt=[1, 2], max_new_tokens=5, temperature=0.0)
    f2 = svc.submit(prompt=[3, 4], max_new_tokens=5, temperature=0.0)
    say("OUT2A", f1.result(timeout=60).out_tokens)
    say("OUT2B", f2.result(timeout=60).out_tokens)
    # a prefix-cache hit: the repeat's suffix prefill is replayed by the
    # follower from its PREFILL_SUFFIX frame
    long_prompt = list(range(1, 12))  # more than one page (page size 8)
    a, b = run(long_prompt, 3), run(long_prompt, 3)
    assert svc.engine.prefix_cache.hits >= 1, "the repeat must hit the cache"
    say("PREFIXA", a)
    say("PREFIXB", b)
    # a chunked prefill: 20 tokens in segments of --max-prefill-tokens 8
    say("CHUNKED", run(list(range(30, 50)), 4))


def collective_inputs(tp: int, dtype: torch.dtype) -> list:
    """Every rank's part of the collectives' inputs, the same in every
    process: [5, 33] values over several magnitudes."""
    rng = np.random.default_rng(tp)
    return [torch.from_numpy(rng.standard_normal((5, 33)).astype(np.float32)).to(dtype) * 10 ** r
            for r in range(tp)]


def run_collectives(mesh, tp: int) -> dict:
    """Each collective on every dtype, this process's ranks' results (None
    for the others'); the tokens broadcast from rank 0."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        full = collective_inputs(tp, dtype)
        parts = mesh.per_rank(lambda r: full[r])
        key = str(dtype).split(".")[-1]
        out[f"all_reduce_sum/{key}"] = mesh.all_reduce_sum(parts)
        out[f"gather/{key}"] = [mesh.gather(parts, dim=-1)]
        out[f"all_gather/{key}"] = mesh.all_gather(parts, dim=0)
        out[f"ring_shift/{key}"] = mesh.ring_shift(parts, "tp")
    like = torch.zeros(4, dtype=torch.int32)
    out["broadcast"] = [mesh.broadcast(torch.tensor([3, 1, 4, 1], dtype=torch.int64) if mesh.is_local(0) else None,
                                       like)]
    return out


def mesh_collectives(pid: int, port: int, tp: int, path: str) -> None:
    """Join a two-process Gloo group, run :func:`run_collectives` on a tp
    mesh of ``cpu`` ranks (tp / 2 in each process) and save the results."""
    import torch.distributed as dist

    from llm_d_fast_model_actuation_tpu_torch.parallel.mesh import MeshPlan, make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=pid)
    mesh = make_mesh(MeshPlan(tp=tp), ["cpu"] * (tp // 2), group=dist.group.WORLD)
    out = run_collectives(mesh, tp)
    out["local_ranks"] = mesh.local_ranks
    out["exchange_stats"] = dict(mesh.exchange_stats)
    torch.save(out, path)
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    if sys.argv[1] == "mesh":
        return mesh_collectives(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    pid, n, port, weights = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    mode = sys.argv[5] if len(sys.argv) > 5 else "normal"
    carry(load_tree(weights))
    from llm_d_fast_model_actuation_tpu_torch.engine import multihost
    from llm_d_fast_model_actuation_tpu_torch.engine.server import EngineService, parse_engine_options

    def say(tag, tokens):
        print(tag, ",".join(map(str, tokens)), flush=True)

    if mode == "idle":
        multihost.COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=2)
    svc = EngineService(parse_engine_options(
        f"{OPTIONS} --device cpu --num-processes {n} --process-id {pid} --coordinator-address 127.0.0.1:{port}"))
    print(f"READY {pid}", flush=True)
    if pid != 0:
        # the follower: alive until the leader's SHUTDOWN frame ends its loop
        while svc._thread.is_alive():
            time.sleep(0.1)
        if svc.failure:
            print(f"FOLLOWER FAILED: {svc.failure}", flush=True)
            sys.exit(1)
        print("DONE 1", flush=True)
        return
    if mode == "serve-wait":
        out = svc.submit(prompt=[5, 6, 7], max_new_tokens=4).result(timeout=60).out_tokens
        # the watchdog has heard every follower: a death from here on is a
        # silence past the timeout, not a member that never checked in
        while len(svc.watchdog._last_seen) < n - 1:
            time.sleep(0.05)
        say("SERVED", out)
        while True:
            time.sleep(0.5)
    if mode == "idle":
        say("BEFORE", svc.submit(prompt=[5, 6, 7], max_new_tokens=4).result(timeout=60).out_tokens)
        time.sleep(float(sys.argv[6]))
        say("AFTER", svc.submit(prompt=[5, 6, 7], max_new_tokens=4).result(timeout=60).out_tokens)
    else:
        traffic(svc, say)
        first = svc.submit(prompt=[5, 6, 7], max_new_tokens=1).result(timeout=60).out_tokens[0]
        info = svc.sleep(1)
        assert info["level"] == 1, info
        print("SLEPT", info.get("bytes_offloaded", 0), flush=True)
        svc.wake_up()
        again = svc.submit(prompt=[5, 6, 7], max_new_tokens=1).result(timeout=60).out_tokens[0]
        # continuity across a gang-wide sleep and wake: the same first token
        print("OUT3", again, first, flush=True)
    svc.shutdown()
    print("DONE 0", flush=True)


if __name__ == "__main__":
    main()
