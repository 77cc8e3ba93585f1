"""The parked bundle's wire (``engine/parked.py``) against the JAX
package's: from the same numpy bundle both packages write the same
document, key for key and byte for byte; each package decodes the
other's; bf16 pages decode with torch alone (no ``ml_dtypes``); a tampered
chunk, a short chunk list and another version are refused. And the two
transfers on the CPU: chunk by chunk, a fault point per chunk, the page-in
written into the pool's own tensors."""

import json
import os
import pathlib
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from llm_d_fast_model_actuation_tpu.engine import engine as jengine
from llm_d_fast_model_actuation_tpu.engine import parked as jparked
from llm_d_fast_model_actuation_tpu_torch.engine import engine as tengine
from llm_d_fast_model_actuation_tpu_torch.engine import parked as tparked
from llm_d_fast_model_actuation_tpu_torch.engine.kv_cache import PagePool
from llm_d_fast_model_actuation_tpu_torch.utils import faults

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: [layers, pages, page_size, kv_heads, head_dim], the reference's layout
SHAPE = (2, 5, 4, 2, 8)
IDENTITY = {"model": "hf:/m", "checkpoint_dir": "/m", "weight_fingerprint": "ab" * 32, "page_size": 4,
            "vocab_size": 64, "max_model_len": 64}


def _fill(req, i: int):
    req.top_p = 0.9
    req.presence_penalty = 0.25
    req.frequency_penalty = 0.5
    req.want_top_logprobs = True
    req.seed = 11 + i if i else None
    req.ignore_eos = bool(i % 2)
    req.out_tokens = [3 + i, 4, 5]
    req.out_logprobs = [-0.5, -1.25, -2.0]
    req.out_top_logprobs = [[(3, -0.5), (9, -1.5)], [], [(5, -2.0)]]
    req.pos = 7 + i
    req.cached_tokens = 4
    req.streamed = 2
    req.stop_seqs = ((9, 9),)
    req.logit_bias = {7: 4.0, 11: -6.0}
    return req


def _bundles(dtype: str):
    """The same bundle for both packages: a JAX one over numpy arrays, a
    port one over torch tensors (page-major), with equal requests."""
    rng = np.random.default_rng(0)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    k = rng.standard_normal(SHAPE).astype(np_dtype)
    v = rng.standard_normal(SHAPE).astype(np_dtype)
    pages = [4, 9, 2, 17, 3]
    counts = rng.integers(0, 5, 64).astype(np.int32)
    key = np.array([123, 456], dtype=np.uint32)
    kv_nbytes = k.nbytes + v.nbytes

    def reqs(cls):
        live = _fill(cls(seq_id=5, prompt=[1, 2, 3, 4, 5, 6, 7], max_new_tokens=9, temperature=0.0), 0)
        waiting = _fill(cls(seq_id=6, prompt=[8, 9], max_new_tokens=4, temperature=0.7), 1)
        return live, waiting

    jl, jw = reqs(jengine.Request)
    tl, tw = reqs(tengine.Request)
    jb = jparked.ParkedRequests(live=[jparked.ParkedRequest(req=jl, old_pages=pages[:2], counts_row=counts,
                                                            key_data=key)],
                                waiting=[jw], page_ids=pages, k_host=k, v_host=v, kv_nbytes=kv_nbytes,
                                nbytes=kv_nbytes + counts.nbytes + key.nbytes, pageout_s=0.25)

    def page_major(a):
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16) if dtype == "bfloat16" \
            else torch.from_numpy(a.copy())
        return t.transpose(0, 1).contiguous()

    tb = tparked.ParkedRequests(live=[tparked.ParkedRequest(req=tl, old_pages=pages[:2], counts_row=counts,
                                                            key_data=key)],
                                waiting=[tw], page_ids=pages, k_host=page_major(k), v_host=page_major(v),
                                kv_nbytes=kv_nbytes, nbytes=kv_nbytes + counts.nbytes + key.nbytes, pageout_s=0.25)
    return jb, tb


# one page per chunk: several chunks in the document
CHUNK = 2 * SHAPE[0] * SHAPE[2] * SHAPE[3] * SHAPE[4] * 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_both_packages_write_the_same_document(dtype):
    jb, tb = _bundles(dtype)
    jdoc = jparked.encode_wire(jb, IDENTITY, chunk_bytes=CHUNK)
    tdoc = tparked.encode_wire(tb, IDENTITY, chunk_bytes=CHUNK)
    assert len(tdoc["kv"]["chunks"]) > 1 and tdoc["kv"]["dtype"] == dtype
    assert tdoc == jdoc
    assert json.dumps(tdoc) == json.dumps(jdoc)


def _as_np(t: torch.Tensor) -> np.ndarray:
    """A page-major host copy in the reference's layout, as numpy."""
    t = t.transpose(0, 1).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_package_decodes_the_others(dtype):
    jb, tb = _bundles(dtype)
    jdoc = jparked.encode_wire(jb, IDENTITY, chunk_bytes=CHUNK)
    tdoc = tparked.encode_wire(tb, IDENTITY, chunk_bytes=CHUNK)
    # the port reads the reference's document ...
    got, pending = tparked.decode_wire(json.loads(json.dumps(jdoc)), tengine.Request)
    assert pending == [] and got.page_ids == jb.page_ids and got.kv_nbytes == jb.kv_nbytes
    assert np.array_equal(_as_np(got.k_host).view(np.uint8), jb.k_host.view(np.uint8))
    assert np.array_equal(_as_np(got.v_host).view(np.uint8), jb.v_host.view(np.uint8))
    assert tparked.encode_request(got.live[0].req) == jparked.encode_request(jb.live[0].req)
    assert tparked.encode_request(got.waiting[0]) == jparked.encode_request(jb.waiting[0])
    assert np.array_equal(got.live[0].counts_row, jb.live[0].counts_row)
    assert tparked.key_kind(got.live[0].key_data) == "jax"
    # ... and the reference reads the port's
    back, _ = jparked.decode_wire(json.loads(json.dumps(tdoc)), jengine.Request)
    assert np.array_equal(back.k_host.view(np.uint8), jb.k_host.view(np.uint8))
    assert np.array_equal(back.v_host.view(np.uint8), jb.v_host.view(np.uint8))
    assert jparked.encode_request(back.live[0].req) == tparked.encode_request(tb.live[0].req)
    # and both round trips write the document again
    assert tparked.encode_wire(got, IDENTITY, chunk_bytes=CHUNK) == jdoc


def test_bf16_pages_decode_without_ml_dtypes(tmp_path):
    """The card's machine has no ml_dtypes: the port decodes bf16 pages
    with torch alone."""
    jb, _ = _bundles("bfloat16")
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(jparked.encode_wire(jb, IDENTITY, chunk_bytes=CHUNK)))
    want = jb.k_host.view(np.uint16).sum(dtype=np.int64)
    code = (
        "import json, sys\n"
        "for m in ('jax', 'llm_d_fast_model_actuation_tpu', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from llm_d_fast_model_actuation_tpu_torch.engine import engine, parked\n"
        f"b, _ = parked.decode_wire(json.load(open({str(path)!r})), engine.Request)\n"
        "assert b.k_host.dtype == torch.bfloat16\n"
        "print(int(b.k_host.view(torch.int16).to(torch.int64).bitwise_and(0xFFFF).sum()))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == int(want)


def _tampered(doc):
    ch = doc["kv"]["chunks"][0]
    ch["k"] = ch["k"][:-8] + "AAAAAAA="


def _short(doc):
    doc["kv"]["chunks"].pop()


def _version(doc):
    doc["version"] = 2


@pytest.mark.parametrize("spoil,match", [(_tampered, "digest"), (_short, "do not cover"), (_version, "version")])
def test_a_spoiled_document_is_refused(spoil, match):
    _, tb = _bundles("float32")
    doc = json.loads(json.dumps(tparked.encode_wire(tb, IDENTITY, chunk_bytes=CHUNK)))
    spoil(doc)
    with pytest.raises(ValueError, match=match):
        tparked.decode_wire(doc, tengine.Request)
    with pytest.raises(ValueError, match=match):
        jparked.decode_wire(doc, jengine.Request)


def test_the_weight_fingerprint_is_the_references():
    digests = {"layers/wq": "aa", "embed": "bb", "lm_head": "cc"}
    assert tparked.weight_fingerprint(digests) == jparked.weight_fingerprint(dict(reversed(digests.items())))


def test_key_kinds():
    gen = torch.Generator().manual_seed(3)
    assert tparked.key_kind(gen.get_state().numpy()) == "torch"
    assert tparked.key_kind(np.array([7], dtype=np.uint64)) == "torch"
    assert tparked.key_kind(np.array([1, 2], dtype=np.uint32)) == "jax"
    assert tparked.key_kind(tparked.greedy_key()) == "jax" and tparked.key_kind(None) == ""


def _pool(pages: int = 12):
    pool = PagePool.create(3, pages, 4, 2, 8, dtype=torch.float32)
    for t in pool.tensors():
        t.copy_(torch.randn(t.shape))
    return pool


def test_the_transfers_move_whole_pages_chunk_by_chunk():
    """The page-out gathers the listed pages chunk by chunk (a fault point
    and a span each), page-major; the page-in writes them into another
    pool's own tensors (no new tensor) at the pages it is given."""
    src, dst = _pool(), _pool()
    ids = [7, 2, 9, 4, 11]
    per_page = tparked.page_nbytes(src.k_pages, src.v_pages)
    ptrs = [t.data_ptr() for t in dst.tensors()]
    faults.arm("kvsave.d2h", mode="delay", delay_s=0.0)
    faults.arm("kvrestore.h2d", mode="delay", delay_s=0.0)
    try:
        k, v, pin_s = tparked.gather_pages_d2h(src, ids, bucket_bytes=2 * per_page)
        assert faults.describe()["armed"]["kvsave.d2h"]["fired"] == 3  # 2 + 2 + 1 pages
        assert pin_s >= 0 and k.shape == (5, 3, 4, 2, 8)
        assert torch.equal(k, src.k_pages[:, ids].transpose(0, 1)) and torch.equal(v, src.v_pages[:, ids].transpose(0, 1))
        pairs = [(0, 1), (1, 3), (3, 5), (4, 6)]  # page 2 of the list is not wanted
        moved = tparked.scatter_pages_h2d(dst, pairs, k, v, bucket_bytes=3 * per_page)
        assert faults.describe()["armed"]["kvrestore.h2d"]["fired"] == 2
    finally:
        faults.reset()
    assert moved == 4 * per_page and [t.data_ptr() for t in dst.tensors()] == ptrs
    for s, d in pairs:
        assert torch.equal(dst.k_pages[:, d], k[s]) and torch.equal(dst.v_pages[:, d], v[s])


def test_a_failed_page_out_leaves_the_pool_as_it_was():
    pool = _pool()
    before = [t.clone() for t in pool.tensors()]
    faults.arm("kvsave.d2h", mode="fail", count=1)
    try:
        with pytest.raises(faults.FaultError):
            tparked.gather_pages_d2h(pool, [1, 2, 3])
    finally:
        faults.reset()
    assert all(torch.equal(a, b) for a, b in zip(before, pool.tensors()))
