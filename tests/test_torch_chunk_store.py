"""The port's content-addressed chunk store and tiered model pool
(``engine/chunk_store.py``, ``engine/model_pool.py``) held against the
reference's: digest strings equal for equal bits, the refcount and dedup
accounting, the disk tier (round trip, content verify, LRU budget,
restart; a blob either package spilled is read back bit-exact by the
other), and the pool's LRU, budget, manifests and staged rebuilds, the
same sequences through both pools giving the same ``describe()``."""

import glob
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import chunk_store as jcs
from llm_d_fast_model_actuation_tpu.engine import model_pool as jmp
from llm_d_fast_model_actuation_tpu_torch.engine import chunk_store as tcs
from llm_d_fast_model_actuation_tpu_torch.engine import model_pool as tmp_


def _np(t: torch.Tensor) -> np.ndarray:
    """The numpy array with ``t``'s bits (bf16 through ml_dtypes)."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.contiguous().numpy()


def _tree_np(tree):
    return {k: _tree_np(v) for k, v in tree.items()} if isinstance(tree, dict) else _np(tree)


CASES = {
    "f32": lambda g: torch.randn(4, 8, generator=g),
    "bf16": lambda g: torch.randn(2, 3, 4, generator=g).to(torch.bfloat16),
    "f16": lambda g: torch.randn(16, generator=g).to(torch.float16),
    "i32": lambda g: torch.randint(-100, 100, (33, 3), generator=g, dtype=torch.int32),
    "i8": lambda g: torch.randint(-100, 100, (7,), generator=g, dtype=torch.int8),
    "empty": lambda g: torch.empty(0, dtype=torch.int32),
    "transposed": lambda g: torch.randn(8, 4, generator=g).t(),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_leaf_digest_equals_the_reference(case):
    t = CASES[case](torch.Generator().manual_seed(0))
    assert tcs.leaf_digest(t) == jcs.leaf_digest(_np(t))
    # content, shape and dtype all count
    if t.dim() > 1:
        assert tcs.leaf_digest(t) != tcs.leaf_digest(t.reshape(-1))
    if t.numel():
        assert tcs.leaf_digest(t) != tcs.leaf_digest(t.to(torch.float64))


def test_digest_tree_digest_leaves_and_unflatten_equal_the_reference():
    g = torch.Generator().manual_seed(1)
    tree = {"embed": torch.randn(64, 32, generator=g).to(torch.bfloat16),
            "layers": {"wq": torch.randn(2, 32, 32, generator=g), "wk": torch.randn(2, 32, 16, generator=g)}}
    want = jcs.digest_tree(_tree_np(tree))
    assert tcs.digest_tree(tree) == want
    flat = {"embed": tree["embed"], "layers/wq": tree["layers"]["wq"], "layers/wk": tree["layers"]["wk"]}
    assert tcs.digest_leaves(flat) == want == tcs.digest_leaves(flat, workers=1)
    assert tcs.unflatten_tree(flat).keys() == jcs.unflatten_tree(flat).keys()
    assert tcs.unflatten_tree(flat)["layers"].keys() == jcs.unflatten_tree(flat)["layers"].keys()


def test_aligned_digests_params_prefix():
    """The port's state names its parameters with dots (``layers.wq``);
    they align with the reference's nested keys, KV leaves get None."""
    z = torch.zeros(2)
    state = {"params": {"embed": z, "layers.wq": z, "layers.wk": z, "lm_head": z}, "kv": [z, z]}
    digests = {"embed": "d-embed", "layers/wq": "d-wq", "layers/wk": "d-wk"}
    jstate = {"params": {"embed": 0, "layers": {"wq": 0, "wk": 0}, "lm_head": 0}, "kv": (0, 0)}
    want = jcs.aligned_digests(jstate, digests, prefix="params")
    assert tcs.aligned_digests(state, digests, prefix="params") == want == [None, None, "d-embed", "d-wk", "d-wq", None]
    assert tcs.aligned_digests(state, None) == [None] * 6
    assert len(tcs.flatten_state(state)) == 6


def test_intern_refcount_and_dedup_accounting():
    cs = tcs.ChunkStore()
    a = torch.arange(64, dtype=torch.float32)
    d = tcs.leaf_digest(a)
    c1, added1 = cs.intern(d, a)
    assert c1 is a and added1 == 256 and cs.host_bytes == 256
    c2, added2 = cs.intern(d, a.clone())
    # the canonical tensor is the FIRST one: the caller drops its duplicate
    assert c2 is a and added2 == 0
    assert cs.dedup_saved_bytes == 256 and cs.dedup_hits == 1
    assert cs.release(d) == 0 and cs.host_bytes == 256 and cs.dedup_saved_bytes == 0
    assert cs.release(d) == 256 and cs.host_bytes == 0
    assert cs.fetch(d) is None


def _spill_all(store, digest, arrays):
    for d, a in zip(digest, arrays):
        store.intern(d, a)
        store.release(d)  # the last reference: spilled


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_disk_tier_round_trip_bit_exact_and_read_by_either_package(tmp_path, writer):
    tensors = [torch.arange(32, dtype=torch.float32).reshape(4, 8),
               torch.linspace(-1, 1, 24).to(torch.bfloat16).reshape(2, 3, 4),
               torch.empty(0, dtype=torch.int32)]
    digests = [tcs.leaf_digest(t) for t in tensors]
    if writer == "port":
        store = tcs.ChunkStore(disk_dir=str(tmp_path), disk_budget_bytes=1 << 20)
        _spill_all(store, digests, tensors)
    else:
        store = jcs.ChunkStore(disk_dir=str(tmp_path), disk_budget_bytes=1 << 20)
        _spill_all(store, digests, [_np(t) for t in tensors])
    assert store.disk_spills == 3
    port = tcs.ChunkStore(disk_dir=str(tmp_path), disk_budget_bytes=1 << 20)
    ref = jcs.ChunkStore(disk_dir=str(tmp_path), disk_budget_bytes=1 << 20)
    for d, t in zip(digests, tensors):
        got, gotj = port.fetch(d), ref.fetch(d)
        assert got.dtype == t.dtype and got.shape == t.shape
        assert torch.equal(got.view(torch.uint8) if got.numel() else got, t.contiguous().view(torch.uint8)
                           if t.numel() else t), "disk round trip not bit-exact"
        assert gotj.tobytes() == _np(t).tobytes() and gotj.shape == tuple(t.shape)
    assert port.disk_hits == 3


def test_disk_reload_content_verify_rejects_corruption(tmp_path):
    cs = tcs.ChunkStore(disk_dir=str(tmp_path), disk_budget_bytes=1 << 20)
    a = torch.arange(100, dtype=torch.float32)
    d = tcs.leaf_digest(a)
    _spill_all(cs, [d], [a])
    (path,) = glob.glob(str(tmp_path / "*.chunk"))
    raw = open(path, "rb").read()
    with open(path, "wb") as f:  # one payload bit flipped, the header kept
        f.write(raw[:-1] + bytes([raw[-1] ^ 1]))
    assert cs.fetch(d) is None and cs.verify_failures == 1
    assert not os.path.exists(path), "a corrupt blob is deleted"
    assert cs.fetch(d) is None


def test_disk_tier_lru_budget_and_restart(tmp_path):
    a, b, c = (torch.full((256,), v, dtype=torch.uint8) for v in (0, 1, 2))
    da, db, dc = (tcs.leaf_digest(x) for x in (a, b, c))
    cs = tcs.ChunkStore(disk_dir=str(tmp_path), disk_budget_bytes=800)  # about two blobs
    _spill_all(cs, [da, db, dc], [a, b, c])
    assert cs.disk_evictions >= 1
    assert cs.fetch(da) is None and cs.fetch(dc) is not None
    # a fresh store over the same directory adopts the spilled chunks
    cs2 = tcs.ChunkStore(disk_dir=str(tmp_path), disk_budget_bytes=800)
    assert torch.equal(cs2.fetch(dc), c) and cs2.disk_bytes > 0


def _pool_sequence(pool):
    """The reference's pool test sequences, run on ``pool``; returns what
    each step answered."""
    out = [[e.model_id for e in pool.put("a", "rt-a", 40)], [e.model_id for e in pool.put("b", "rt-b", 40)]]
    out.append([e.model_id for e in pool.put("c", "rt-c", 40)])
    hit = pool.take("b")
    out += [hit.runtime, pool.take("zzz"), pool.bytes_used]
    pool.put("b", "rt-b2", 40)
    pool.put("c", "rt-c2", 40)
    out.append([e.model_id for e in pool.put("d", "rt-d", 40)])
    pool.put("m@/ckpt/a", "rt-ma", 10)
    pool.put("m@/ckpt/b", "rt-mb", 10)
    out += [pool.take_match("m").runtime, pool.take_match("m").runtime, pool.take_match("m")]
    out.append([e.model_id for e in pool.put("big", "rt", 101)])
    out.append(pool.describe())
    return out


def test_pool_lru_budget_take_match_and_oversize_as_the_reference():
    assert _pool_sequence(tmp_.HostModelPool(budget_bytes=100)) == _pool_sequence(jmp.HostModelPool(budget_bytes=100))
    pool = tmp_.HostModelPool(budget_bytes=0)
    assert [e.model_id for e in pool.put("a", "rt", 1)] == ["a"] and len(pool) == 0


def test_pool_intern_two_variants_share_base_evict_one_bit_exact():
    cs = tcs.ChunkStore()
    pool = tmp_.HostModelPool(budget_bytes=1 << 20, chunks=cs)
    base = torch.arange(1000, dtype=torch.float32)
    tree_a = {"base": base.clone(), "head": torch.zeros(10)}
    tree_b = {"base": base.clone(), "head": torch.ones(10)}
    dg_a, dg_b = tcs.digest_tree(tree_a), tcs.digest_tree(tree_b)
    ia, held_a, nom_a = pool.intern_tree(tree_a, dg_a, prefix="")
    ib, held_b, nom_b = pool.intern_tree(tree_b, dg_b, prefix="")
    assert ib["base"] is ia["base"]  # one chunk for the shared base
    assert cs.host_bytes == 4000 + 40 + 40 and cs.dedup_saved_bytes == 4000
    pool.put("a", "rt-a", 4040, chunk_digests=held_a, weight_digests=dg_a, interned_bytes=nom_a)
    pool.put("b", "rt-b", 4040, chunk_digests=held_b, weight_digests=dg_b, interned_bytes=nom_b)
    assert pool.bytes_used == 4080 < 2 * 4040
    assert pool.take("a") is not None
    assert cs.fetch(dg_a["base"]) is ib["base"]
    assert torch.equal(ib["base"], base) and torch.equal(ib["head"], torch.ones(10))


def test_pool_manifest_reconstruction_and_stale_miss(tmp_path):
    cs = tcs.ChunkStore(disk_dir=str(tmp_path), disk_budget_bytes=1 << 20)
    pool = tmp_.HostModelPool(budget_bytes=4096, chunks=cs)
    tree = {"w": torch.arange(512, dtype=torch.float32), "nested": {"b": torch.ones(4)}}
    dg = tcs.digest_tree(tree)
    _, held, nom = pool.intern_tree(tree, dg, prefix="")
    # oversize: straight through to the disk tier, the manifest recorded
    evicted = pool.put("m@ck", "rt", 4097, chunk_digests=held, weight_digests=dg, interned_bytes=nom)
    assert [e.model_id for e in evicted] == ["m@ck"] and cs.disk_spills == 2
    rebuilt, digests, key, tier = pool.take_staged_match("m")
    assert key == "m@ck" and digests == dg and tier == "disk"
    assert torch.equal(rebuilt["w"], tree["w"]) and torch.equal(rebuilt["nested"]["b"], tree["nested"]["b"])
    assert pool.staged_hits == 1 and pool.take_staged("m@ck") is None
    # a blob deleted on disk: the whole model is a miss
    _, held2, nom2 = pool.intern_tree(tree, dg, prefix="")
    pool.put("m@ck", "rt", 4097, chunk_digests=held2, weight_digests=dg, interned_bytes=nom2)
    os.unlink(glob.glob(str(tmp_path / "*.chunk"))[0])
    assert pool.take_staged("m@ck") is None and pool.staged_misses == 1
    # a manifest put back is served again, from what the tiers still hold
    alive = {k: d for k, d in dg.items() if d in cs._disk}
    assert len(alive) == 1
    pool.remember_manifest("m@ck", alive, 2048)
    assert pool.take_staged("m@ck")[2] == "disk"


def test_pool_staged_rebuild_from_host_tier_via_sibling(tmp_path):
    cs = tcs.ChunkStore(disk_dir=str(tmp_path), disk_budget_bytes=1 << 20)
    pool = tmp_.HostModelPool(budget_bytes=4096, chunks=cs)
    tree = {"w": torch.arange(512, dtype=torch.float32)}
    dg = tcs.digest_tree(tree)
    it_s, held_s, nom_s = pool.intern_tree(tree, dg, prefix="")
    pool.put("s", "rt-s", 2048, chunk_digests=held_s, weight_digests=dg, interned_bytes=nom_s)
    _, held_m, nom_m = pool.intern_tree(dict(tree), dg, prefix="")
    pool.put("m@ck", "rt-m", 4097, chunk_digests=held_m, weight_digests=dg, interned_bytes=nom_m)
    rebuilt, _, tier = pool.take_staged("m@ck")
    assert tier == "host" and rebuilt["w"] is it_s["w"] and cs.disk_hits == 0


def test_pool_bytes_used_running_counter():
    pool = tmp_.HostModelPool(budget_bytes=100)
    pool.put("a", "rt", 30)
    pool.put("b", "rt", 50)
    assert pool.bytes_used == 80
    assert [e.model_id for e in pool.put("c", "rt", 40)] == ["a"] and pool.bytes_used == 90
    pool.take("b")
    assert pool.bytes_used == 40
    assert [e.model_id for e in pool.drain()] == ["c"] and pool.bytes_used == 0
