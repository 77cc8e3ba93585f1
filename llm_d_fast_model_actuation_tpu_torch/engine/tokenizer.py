"""Tokenization for the port's OpenAI-facing server.

Port of ``llm_d_fast_model_actuation_tpu/engine/tokenizer.py``, the whole
module and its behaviour: when the served model directory (or
``--tokenizer``) carries tokenizer files, text prompts, chat templates,
stop strings and response text all go through the model's own Hugging
Face tokenizer (``transformers``, imported only when one is loaded);
without tokenizer files the byte-level fallback keeps the token-id API
fully functional. A directory WITH tokenizer files on a machine without
``transformers`` is refused, naming the package: text never quietly
falls back to bytes.

Streaming uses `IncrementalDecoder`: decoding token-by-token is wrong for
SentencePiece/BPE (word-boundary markers, multi-byte codepoints split
across tokens), so deltas are computed as decode(all)[len(prev):], holding
back a trailing U+FFFD that marks an incomplete byte sequence.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence


def _fallback_chat_text(messages: Sequence[Any]) -> str:
    """Role-tagged flattening for models without a chat template."""
    parts: List[str] = []
    for m in messages:
        parts.append(f"<|{m['role']}|>\n{m['content']}\n")
    parts.append("<|assistant|>\n")
    return "".join(parts)


class ByteTokenizer:
    """UTF-8 bytes as token ids — the no-tokenizer fallback."""

    eos_token_id: Optional[int] = None

    def encode(self, text: str, special: bool = True) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, tokens: Sequence[int], skip_special: bool = True) -> str:
        return bytes(t % 256 for t in tokens).decode(
            "utf-8", errors="replace"
        )

    def chat_tokens(self, messages: Sequence[Any]) -> List[int]:
        return self.encode(_fallback_chat_text(messages))


class HFTokenizer:
    """A Hugging Face tokenizer loaded from a LOCAL directory (the image
    has no network egress; models ship their tokenizers alongside the
    weights, exactly as vLLM consumes them)."""

    def __init__(self, path: str) -> None:
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise RuntimeError(
                f"{path!r} holds tokenizer files, and loading them needs the "
                f"transformers package, which is not installed ({e}); this "
                "server does not fall back to bytes for a model that has a "
                "tokenizer"
            ) from e

        self._tok = AutoTokenizer.from_pretrained(
            path, local_files_only=True
        )

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._tok.eos_token_id

    def encode(self, text: str, special: bool = True) -> List[int]:
        return list(self._tok.encode(text, add_special_tokens=special))

    def decode(self, tokens: Sequence[int], skip_special: bool = True) -> str:
        """skip_special=True (streamed/assembled response text) hides
        BOS/EOS markers like vLLM's default detokenizer; callers that need
        the literal text — echo of the original prompt, single-token
        decodes for logprob alternative keys (distinct special ids must
        not all merge into '') — pass skip_special=False."""
        return self._tok.decode(
            list(tokens), skip_special_tokens=skip_special
        )

    def chat_tokens(self, messages: Sequence[Any]) -> List[int]:
        if getattr(self._tok, "chat_template", None):
            return list(
                self._tok.apply_chat_template(
                    list(messages), add_generation_prompt=True
                )
            )
        return self.encode(_fallback_chat_text(messages))


#: files whose presence marks an HF tokenizer directory
_TOKENIZER_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "tokenizer.model",
    "vocab.json",
)


def has_tokenizer_files(path: str) -> bool:
    return any(
        os.path.isfile(os.path.join(path, f)) for f in _TOKENIZER_FILES
    )


def load_tokenizer(path: str = ""):
    """HFTokenizer for a directory path, ByteTokenizer for ''."""
    if path:
        return HFTokenizer(path)
    return ByteTokenizer()


class IncrementalDecoder:
    """Stream-safe detokenization: each push returns the NEW text the
    growing token sequence decodes to, never re-emitting and never
    emitting the replacement character for a not-yet-complete byte
    sequence (it flushes once the continuation tokens arrive).

    Cost is O(window) per push, not O(tokens-so-far): only the tokens
    since the last emission (plus a small already-emitted context window
    for tokenizers whose spacing depends on the previous token) are
    re-decoded — the prefix/read-offset scheme vLLM's incremental
    detokenizer uses."""

    def __init__(self, tokenizer) -> None:
        self._tok = tokenizer
        self._tokens: List[int] = []
        self._prefix = 0  # start of the decode context window
        self._read = 0  # tokens whose text has been emitted

    def push(self, token: int) -> str:
        self._tokens.append(int(token))
        ctx = self._tok.decode(self._tokens[self._prefix : self._read])
        full = self._tok.decode(self._tokens[self._prefix :])
        # a trailing U+FFFD marks a split multi-byte sequence: hold until
        # the continuation tokens arrive (flush releases a genuine one)
        if len(full) > len(ctx) and not full.endswith("�"):
            out = full[len(ctx) :]
            self._prefix = self._read
            self._read = len(self._tokens)
            return out
        return ""

    def flush(self) -> str:
        """Release any held tail (e.g. a trailing U+FFFD from a byte
        sequence the stream ended mid-way through) so streamed text equals
        the full decode exactly."""
        ctx = self._tok.decode(self._tokens[self._prefix : self._read])
        full = self._tok.decode(self._tokens[self._prefix :])
        self._read = len(self._tokens)
        return full[len(ctx) :]


class TextStopStream:
    """Streaming stop-STRING matching on decoded text (OpenAI semantics).

    String stops cannot be matched as token sequences: BPE does not
    round-trip decode→encode per token, and a stop string can start
    mid-token. This filter sits between the engine's token stream and the
    SSE writer: `push` returns (text_safe_to_emit, ids, matched). Text
    that could be the start of a stop string is held back until
    disambiguated; on a match, everything before the stop is returned and
    the stream is over. `flush` releases held text when generation ends
    without a match.

    `ids` are the token ids whose decoded text is FULLY contained in the
    returned text, so streamed ids account for exactly the delivered text
    at token granularity: each pushed token's chars are tracked through
    the hold-back window, a token is delivered with the emission that
    completes its text, and a token straddling a stop cut is suppressed
    with the stop (the cut-before-the-matching-token rule of
    truncate_at_text_stop)."""

    def __init__(self, tokenizer, stop_texts) -> None:
        self._dec = IncrementalDecoder(tokenizer)
        self._stops = [s for s in stop_texts if s]
        self._pending = ""
        #: [token id, chars of _pending attributed to it] in arrival order;
        #: invariant: sum of chars == len(_pending)
        self._idq: List[list] = []

    def _take_ids(self, k: int) -> List[int]:
        """Pop the ids whose attributed chars lie within the first `k`
        chars of the pending window (a token partially inside stays
        queued, its remaining char count reduced)."""
        out: List[int] = []
        while self._idq and k >= 0:
            tid, n = self._idq[0]
            if n <= k:
                k -= n
                out.append(tid)
                self._idq.pop(0)
                if k == 0:
                    break
            else:
                self._idq[0][1] = n - k
                break
        return out

    def push(self, token: int):
        new = self._dec.push(token)
        self._pending += new
        self._idq.append([int(token), len(new)])
        cut = -1
        for s in self._stops:
            j = self._pending.find(s)
            if j >= 0 and (cut < 0 or j < cut):
                cut = j
        if cut >= 0:
            out = self._pending[:cut]
            ids = self._take_ids(cut) if cut else []
            self._pending = ""
            self._idq = []
            return out, ids, True
        hold = 0
        for s in self._stops:
            m = min(len(s) - 1, len(self._pending))
            for k in range(m, hold, -1):
                if self._pending.endswith(s[:k]):
                    hold = k
                    break
        out = self._pending[: len(self._pending) - hold]
        self._pending = self._pending[len(out) :]
        return out, self._take_ids(len(out)) if out else [], False

    def flush(self):
        """End-of-generation: release held text, SCANNING it for stops
        first — a stop string can hide in a tail the decoder was holding
        (split multi-byte sequence). Returns (text, ids, matched)."""
        tail_new = self._dec.flush()
        if tail_new and self._idq:
            # decoder-held chars surfaced now; they came from the queued
            # tokens — attribute to the newest (greedy, same as push)
            self._idq[-1][1] += len(tail_new)
        tail = self._pending + tail_new
        self._pending = ""
        cut = -1
        for s in self._stops:
            j = tail.find(s)
            if j >= 0 and (cut < 0 or j < cut):
                cut = j
        if cut >= 0:
            ids = self._take_ids(cut) if cut else []
            self._idq = []
            return tail[:cut], ids, True
        ids = [tid for tid, _ in self._idq]
        self._idq = []
        return tail, ids, False


def truncate_at_text_stop(tokenizer, tokens, logprobs, stop_texts):
    """Non-streaming stop-string application: cut the response at the
    first occurrence of any stop string in the decoded text.

    Returns (kept_tokens, kept_logprobs, text, matched). The token list is
    cut BEFORE the token whose arrival completed the match (a stop can
    start mid-token, so text is the authoritative boundary; the token list
    is the best id-aligned approximation).
    """
    tokens = list(tokens)
    if not stop_texts:
        return tokens, list(logprobs), tokenizer.decode(tokens), False
    dec = IncrementalDecoder(tokenizer)
    text = ""
    max_stop = max(len(s) for s in stop_texts)
    for i, t in enumerate(tokens):
        new = dec.push(t)
        text += new
        # a fresh match must involve newly-emitted chars: bound the scan
        start = max(0, len(text) - len(new) - max_stop)
        cut = -1
        for s in stop_texts:
            if not s:
                continue
            j = text.find(s, start)
            if j >= 0 and (cut < 0 or j < cut):
                cut = j
        if cut >= 0:
            return tokens[:i], list(logprobs)[:i], text[:cut], True
    # the decoder may have held a tail (split multi-byte sequence) that
    # push never scanned; a stop can hide in it
    text += dec.flush()
    start = max(0, len(text) - max_stop * 2)
    cut = -1
    for s in stop_texts:
        if not s:
            continue
        j = text.find(s, start)
        if j >= 0 and (cut < 0 or j < cut):
            cut = j
    if cut >= 0:
        return tokens, list(logprobs), text[:cut], True
    return tokens, list(logprobs), text, False
