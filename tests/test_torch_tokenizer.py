"""The port's engine/tokenizer.py against the reference module's, on the
same inputs: the byte fallback and a tiny byte-level BPE tokenizer built
here (tests/conftest.py), through encode, decode, chat_tokens, the
incremental decoder, the streaming stop-string filter and the
non-streaming stop cut; and the refusal of a tokenizer directory on a
machine without transformers."""

import builtins

import pytest

from llm_d_fast_model_actuation_tpu.engine import tokenizer as jtok
from llm_d_fast_model_actuation_tpu_torch.engine import tokenizer as ttok
from tests.conftest import build_tiny_bpe_tokenizer_files

TEMPLATE = "{% for m in messages %}<|{{ m['role'] }}|>{{ m['content'] }}\n{% endfor %}<|assistant|>"
TEXTS = ["hello world", "the quick brown fox günther straße", "é", "a\nb  c", ""]
MESSAGES = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hello"}]


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    plain = build_tiny_bpe_tokenizer_files(str(tmp_path_factory.mktemp("plain")))
    chat = build_tiny_bpe_tokenizer_files(str(tmp_path_factory.mktemp("chat")), chat_template=TEMPLATE)
    return {"plain": plain, "chat": chat}


def _pair(kind, tok_dirs):
    if kind == "bytes":
        return jtok.ByteTokenizer(), ttok.ByteTokenizer()
    return jtok.load_tokenizer(tok_dirs[kind]), ttok.load_tokenizer(tok_dirs[kind])


KINDS = ["bytes", "plain", "chat"]


@pytest.mark.parametrize("kind", KINDS)
def test_encode_decode_and_chat_tokens_equal_the_reference(kind, tok_dirs):
    ref, port = _pair(kind, tok_dirs)
    assert port.eos_token_id == ref.eos_token_id
    for text in TEXTS:
        for special in (True, False):
            assert port.encode(text, special=special) == ref.encode(text, special=special)
        ids = ref.encode(text)
        for skip in (True, False):
            assert port.decode(ids, skip_special=skip) == ref.decode(ids, skip_special=skip)
    assert port.chat_tokens(MESSAGES) == ref.chat_tokens(MESSAGES)
    assert ttok.has_tokenizer_files(tok_dirs["plain"]) and not ttok.has_tokenizer_files(str(tok_dirs["plain"]) + "/x")


def _stream(mod, tok, ids, stops):
    filt = mod.TextStopStream(tok, stops)
    out = [filt.push(t) for t in ids]
    return out + [filt.flush()]


@pytest.mark.parametrize("kind", KINDS)
def test_incremental_decoding_and_stops_equal_the_reference(kind, tok_dirs):
    ref, port = _pair(kind, tok_dirs)
    for text in TEXTS[:4]:
        ids = ref.encode(text, special=False)
        jd, td = jtok.IncrementalDecoder(ref), ttok.IncrementalDecoder(port)
        pushed = [(jd.push(t), td.push(t)) for t in ids]
        assert all(a == b for a, b in pushed)
        tail = td.flush()
        assert jd.flush() == tail and "".join(b for _, b in pushed) + tail == port.decode(ids)
        lps = [-0.1 * i for i in range(len(ids))]
        for stops in (("o",), ("quick", "ß"), ("zz",), ("\n",), ()):
            assert _stream(ttok, port, ids, stops) == _stream(jtok, ref, ids, stops)
            assert (ttok.truncate_at_text_stop(port, ids, lps, stops)
                    == jtok.truncate_at_text_stop(ref, ids, lps, stops))


def test_split_multibyte_is_held_back():
    dec = ttok.IncrementalDecoder(ttok.ByteTokenizer())
    b = "é".encode("utf-8")
    assert dec.push(b[0]) == ""
    assert dec.push(b[1]) == "é"


def test_a_tokenizer_directory_without_transformers_is_refused(tok_dirs, monkeypatch):
    """With transformers missing, a directory WITH tokenizer files is
    refused, naming the package: no quiet fallback to bytes."""
    real = builtins.__import__

    def no_transformers(name, *a, **kw):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError("No module named 'transformers'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(RuntimeError, match="transformers"):
        ttok.load_tokenizer(tok_dirs["plain"])
    assert isinstance(ttok.load_tokenizer(""), ttok.ByteTokenizer)
