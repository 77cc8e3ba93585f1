"""The port's state-change reflector (``launcher/notifier.py``), with the
cases of ``tests/test_notifier.py``: the signature (equal to the JAX
notifier's), patch-on-change-only, a failed patch retried, and the full
loop against the port's REST server through the sidecar's own
standard-library client (``HttpSource``): a crash is reflected from the
watch stream, a DELETE published from the executor thread wakes it, and a
resume from an evicted revision falls back to watching from now."""

import asyncio
import time
from typing import List

import pytest
from test_torch_launcher import PortClient, translators
from torch_launcher_fakes import crashing_kickoff, fake_kickoff

from llm_d_fast_model_actuation_tpu.launcher import notifier as jnotifier
from llm_d_fast_model_actuation_tpu_torch.launcher.manager import EngineProcessManager
from llm_d_fast_model_actuation_tpu_torch.launcher.notifier import (
    HttpSource,
    InstanceStateNotifier,
    instance_signature,
)

STATES = [
    [],
    [{"instance_id": "i1", "status": "running"}, {"instance_id": "i2", "status": "running"}],
    [{"instance_id": "i2", "status": "running"}, {"instance_id": "i1", "status": "running"}],
    [{"instance_id": "i1", "status": "stopped"}, {"instance_id": "i2", "status": "running"}],
]


def test_signature_order_insensitive_status_sensitive_and_the_jax_notifiers():
    sigs = [instance_signature(s) for s in STATES]
    assert sigs[1] == sigs[2] and len({sigs[0], sigs[1], sigs[3]}) == 3
    assert sigs == [jnotifier.instance_signature(s) for s in STATES]


def test_reflect_once_patches_only_on_change():
    states = [[{"instance_id": "x", "status": "running"}]]
    patches: List[str] = []

    async def lister():
        return states[0]

    async def patch(sig):
        patches.append(sig)

    n = InstanceStateNotifier(lister, patch)

    async def scenario():
        assert await n.reflect_once() is not None
        assert await n.reflect_once() is None  # unchanged -> no patch
        states[0] = [{"instance_id": "x", "status": "stopped"}]
        assert await n.reflect_once() is not None

    asyncio.run(scenario())
    assert len(patches) == 2 and patches[0] != patches[1]


def test_patch_failure_does_not_swallow_the_change():
    calls = {"n": 0}
    patches: List[str] = []

    async def lister():
        return [{"instance_id": "x", "status": "running"}]

    async def patch(sig):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("kube api hiccup")
        patches.append(sig)

    n = InstanceStateNotifier(lister, patch)

    async def scenario():
        with pytest.raises(RuntimeError):
            await n.reflect_once()
        assert await n.reflect_once() is not None

    asyncio.run(scenario())
    assert len(patches) == 1


def _client(tmp_path, kickoff):
    return PortClient(EngineProcessManager(translators()["port"], log_dir=str(tmp_path), kickoff=kickoff))


def test_watch_driven_reflection_of_crash(tmp_path):
    """CREATE then crash: the notifier, driven by the watch stream through
    ``HttpSource``, patches the signature of the stopped instance."""
    c = _client(tmp_path, crashing_kickoff)
    patches: List[str] = []
    want = instance_signature([{"instance_id": "N", "status": "stopped"}])
    try:
        source = HttpSource(c.url)

        async def patch(sig):
            patches.append(sig)

        async def scenario():
            notifier = InstanceStateNotifier(source.lister, patch, watcher=source.watcher)
            task = asyncio.get_running_loop().create_task(notifier.run())
            try:
                await asyncio.sleep(0.2)  # the initial reflect (empty set)
                put = await asyncio.to_thread(c.request, "PUT", "/v2/vllm/instances/N", {"options": "x"})
                assert put[0] == 201
                # a fast crash may coalesce CREATED+STOPPED into one reflect, so
                # only the final signature is asserted, not the patch count
                deadline = time.time() + 10
                while (not patches or patches[-1] != want) and time.time() < deadline:
                    await asyncio.sleep(0.05)
            finally:
                notifier.stop()
                task.cancel()
                await asyncio.gather(task, return_exceptions=True)
                await source.close()

        asyncio.run(scenario())
    finally:
        c.close()
    assert len(patches) >= 2  # at least: empty set, then the stopped state
    assert len(set(patches)) == len(patches), "each patch must be a new signature"
    assert patches[-1] == want


def test_delete_event_reaches_watchers_from_executor_thread(tmp_path):
    """stop_instance runs on the executor (the REST handler keeps the loop
    live during the blocking SIGTERM/join): the DELETED event published
    from that thread must still wake the stream."""
    c = _client(tmp_path, fake_kickoff)
    try:
        source = HttpSource(c.url)

        async def scenario():
            stream = await source.watcher(0)
            assert (await asyncio.to_thread(c.request, "PUT", "/v2/vllm/instances/D", {"options": "x"}))[0] == 201
            assert (await asyncio.wait_for(stream.__anext__(), 10))["type"] == "CREATED"
            assert (await asyncio.to_thread(c.request, "DELETE", "/v2/vllm/instances/D"))[0] == 200
            event = await asyncio.wait_for(stream.__anext__(), 10)
            assert event["type"] == "DELETED" and event["object"]["status"] == "terminated"
            await stream.aclose()
            assert (await source.lister()) == []
            await source.close()

        asyncio.run(scenario())
    finally:
        c.close()


def test_resume_from_an_evicted_revision_watches_from_now(tmp_path):
    c = _client(tmp_path, fake_kickoff)
    try:
        for i in range(4):
            c.manager._publish("CREATED", {"instance_id": f"e{i}", "revision": None})
        while len(c.manager.broadcaster._buf) > 2:
            c.manager.broadcaster._buf.popleft()
        source = HttpSource(c.url)

        async def scenario():
            stream = await source.watcher(1)  # 410, then the stream from now
            c.manager._publish("CREATED", {"instance_id": "late", "revision": None})
            event = await asyncio.wait_for(stream.__anext__(), 10)
            assert event["object"]["instance_id"] == "late" and event["object"]["revision"] == 5
            await stream.aclose()
            await source.close()

        asyncio.run(scenario())
    finally:
        c.close()
