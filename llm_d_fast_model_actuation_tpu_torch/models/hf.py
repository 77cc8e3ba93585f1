"""Hugging Face checkpoint import: ``config.json`` and the weight shards
of a model directory, written into a model's own tensors.

Port of ``llm_d_fast_model_actuation_tpu/models/hf.py``, every family the
reference reads: ``LlamaForCausalLM`` (Llama 2/3, TinyLlama),
``MistralForCausalLM``, ``Qwen2ForCausalLM`` (q/k/v biases),
``Qwen3ForCausalLM`` (per-head q/k norms), ``GemmaForCausalLM`` and
``MixtralForCausalLM`` (the MoE family, ``models/moe.py``: each layer's
``block_sparse_moe.gate`` is the router, each expert's ``w1``/``w3``/``w2``
its slice ``[l, e]`` of ``w_gate``/``w_up``/``w_down``). The config, eos, shard-layout, routing and
completeness rules are the reference's; the loader differs in where the
weights go:

  * it builds no new tree: :func:`load_params` writes each checkpoint
    tensor IN PLACE into an existing :class:`~.llama.Llama` or
    :class:`~.llama.ShardedLlama` — the engine's, whose parameters are
    views of its arena and whose addresses the captured decode graphs
    hold, so neither an address nor a capture changes;
  * safetensors shards are read by the port's own reader
    (``models/safetensors.py``, over ``mmap``), ``.bin`` shards through
    ``torch.load(weights_only=True, mmap=True)``;
  * every header is read and checked first — routing, shapes, dtypes and
    that every layer slice of every weight is present — so a checkpoint
    that would be refused is refused before a byte is written;
  * the shards are read by a pool of readers (``workers``, the
    reference's pipelined loader), each with its own pair of pinned
    staging buffers and its own copy stream, all of them together at most
    ``LOAD_INFLIGHT_BYTES`` on the host (never the checkpoint); each
    tensor crosses to the device in its own dtype, in row chunks, and is
    transposed and cast on the device into its destination. fp32 -> bf16
    is round to nearest even, the bits of the reference's host cast. The
    loader waits on its own events, never on the whole card, so a build
    captures its graphs meanwhile (``engine/exec_pool.py``);
  * ``place=False`` stages on the host only (a prefetch): the port's
    stacked layout in the config's dtype, transposed on the readers, in
    pinned memory, for :func:`place_staged_params` to copy straight in;
  * on a mesh (``tp``, ``pp``, and ``ep`` for the MoE family) each
    rank's slice is cut from the mapped tensor by ``llama.param_specs``,
    as ``models/convert.py`` cuts it; an expert goes to the ``ep`` ranks
    that hold it, a layer to the ranks of the ``pp`` stage that holds it.

HF stores per-layer ``model.layers.{i}.<name>.weight`` as (out, in); the
port's stacked layouts are (L, in, out) (and (L, E, in, out) for expert
stacks), so a layer's tensor is written transposed into slice ``i`` (an
expert's into ``[i, e]``). The rotate-half RoPE layout and Gemma's
zero-centred norms copy verbatim (``norm_offset``, ``embed_scale``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from ..engine.chunk_store import TORCH_DTYPES, digest_leaves, leaf_paths
from ..parallel.mesh import Mesh, join_for, shard_for
from ..utils import faults, tracing
from . import quant as quant_mod
from .llama import (
    Llama,
    LlamaConfig,
    ShardedLlama,
    held_ranks,
    is_moe,
    layer_at,
    param_dtype,
    param_shapes,
    param_specs,
    quantized_names,
)
from .moe import EXPERT_WEIGHTS, moe_config
from .safetensors import DTYPES, SafetensorsFile

#: HF ``architectures[0]`` -> config-knob overrides for the shared forward
ARCHITECTURES: Dict[str, Dict[str, Any]] = {
    "LlamaForCausalLM": {},
    "MistralForCausalLM": {},
    "Qwen2ForCausalLM": {"attn_bias": True},
    "Qwen3ForCausalLM": {"qk_norm": True},
    "GemmaForCausalLM": {
        "hidden_activation": "gelu",
        "norm_offset": 1.0,
        "embed_scale": True,
        # gemma ties embeddings by default, and config.json omits defaults
        "tie_embeddings": True,
    },
    "MixtralForCausalLM": {},
}

#: host bytes in flight while loading: every reader's two staging
#: buffers together (``--load-inflight-mib``)
LOAD_INFLIGHT_BYTES = 512 << 20


def _read_config(path: str) -> Dict[str, Any]:
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"no config.json under {path!r}")
    with open(cfg_path) as f:
        return json.load(f)


def _int_list(v: Any) -> list:
    """HF eos_token_id may be an int or a list (Llama-3's [eos, eom,
    eot]); normalize to a list of ints."""
    if isinstance(v, list):
        return [int(t) for t in v]
    if isinstance(v, (int, float)):
        return [int(v)]
    return []


def config_from_hf(path: str, **overrides: Any) -> LlamaConfig:
    """A :class:`~.llama.LlamaConfig` from an HF model directory's
    ``config.json``; ``overrides`` force fields (``dtype``,
    ``max_seq_len``, ...); a :class:`~.moe.MoeConfig` for Mixtral, with its
    ``num_local_experts`` and ``num_experts_per_tok``."""
    hf = _read_config(path)
    archs = hf.get("architectures") or []
    arch = archs[0] if archs else "LlamaForCausalLM"
    if arch not in ARCHITECTURES:
        raise ValueError(f"unsupported architecture {arch!r}; supported: {sorted(ARCHITECTURES)}")
    heads = int(hf["num_attention_heads"])
    hidden = int(hf["hidden_size"])
    fields: Dict[str, Any] = {
        "vocab_size": int(hf["vocab_size"]),
        "hidden_size": hidden,
        "num_layers": int(hf["num_hidden_layers"]),
        "num_heads": heads,
        "num_kv_heads": int(hf.get("num_key_value_heads", heads)),
        "head_dim": int(hf.get("head_dim") or hidden // heads),
        "intermediate_size": int(hf["intermediate_size"]),
        "rope_theta": float(hf.get("rope_theta", 10000.0)),
        "rms_eps": float(hf.get("rms_norm_eps", 1e-5)),
        "max_seq_len": int(hf.get("max_position_embeddings", 8192)),
    }
    scaling = hf.get("rope_scaling")
    if scaling:
        rtype = scaling.get("rope_type") or scaling.get("type")
        if rtype == "llama3":
            fields["rope_scaling"] = (
                "llama3",
                float(scaling["factor"]),
                float(scaling["low_freq_factor"]),
                float(scaling["high_freq_factor"]),
                int(scaling["original_max_position_embeddings"]),
            )
        elif rtype == "linear":
            fields["rope_scaling"] = ("linear", float(scaling["factor"]))
        elif rtype not in (None, "default"):
            # an ignored scaling spec would serve silently-wrong logits
            raise ValueError(f"unsupported rope_scaling type {rtype!r} (supported: llama3, linear)")
    sw = hf.get("sliding_window")
    if sw:
        # Mistral-style sliding-window attention: within the window full
        # attention is exactly equivalent, so the servable context is
        # capped at the window instead of silently attending past it
        fields["max_seq_len"] = min(fields["max_seq_len"], int(sw))
    arch_defaults = dict(ARCHITECTURES[arch])
    fields["tie_embeddings"] = bool(hf.get("tie_word_embeddings", arch_defaults.pop("tie_embeddings", False)))
    fields.update(arch_defaults)
    base = LlamaConfig()
    if arch == "MixtralForCausalLM":
        base = moe_config(base, num_experts=int(hf["num_local_experts"]),
                          experts_per_token=int(hf["num_experts_per_tok"]))
    fields.update(overrides)
    return dataclasses.replace(base, **fields)


def eos_token_ids_from_hf(path: str) -> list:
    """ALL declared eos ids (config.json union generation_config.json,
    order-preserving): Llama-3-Instruct ends chat turns with <|eot_id|>,
    a SECOND eos id. Empty when neither file declares one."""
    ids = _int_list(_read_config(path).get("eos_token_id"))
    gen_path = os.path.join(path, "generation_config.json")
    if os.path.isfile(gen_path):
        with open(gen_path) as f:
            for t in _int_list(json.load(f).get("eos_token_id")):
                if t not in ids:
                    ids.append(t)
    return ids


def eos_token_id_from_hf(path: str, default: int = 2) -> int:
    ids = eos_token_ids_from_hf(path)
    return ids[0] if ids else default


# -- weight loading ----------------------------------------------------------


class LoadAborted(RuntimeError):
    """A cold load or a prefetch was cancelled through its abort event."""


@dataclasses.dataclass
class LoadStats:
    """A load's phases, as :func:`load_params` fills them, with the
    reference's field names. ``read_s``: the wall window from the load's
    start to the last tensor staged on the host (the disk read, as pages
    are first touched there, on ``workers`` readers); ``convert_s``: the
    summed time of the transposing and casting copies (device time from
    CUDA events on the card, host time on the CPU and for a host-only
    staging); ``h2d_s``: the wall window of the transfers on the device,
    from the first issued to the last landed (CUDA events; 0 on the CPU);
    ``total_s``: wall time of the call."""

    total_s: float = 0.0
    read_s: float = 0.0
    convert_s: float = 0.0
    h2d_s: float = 0.0
    #: the time the read and the transfers were both in flight, the
    #: transfers' window placed on the load's clock by the event recorded
    #: at its start (0 on the CPU and for a host-only staging)
    overlap_s: float = 0.0
    overlap_frac: float = 0.0
    #: checkpoint bytes read (a tensor once per rank slice it feeds)
    bytes_read: int = 0
    #: bytes moved host -> device, in the checkpoint's dtypes
    bytes_h2d: int = 0
    shards: int = 0
    tensors: int = 0
    #: readers over the shards
    workers: int = 0
    #: whether transfers ran while later tensors were still being read
    #: (every load onto a device; not a host-only staging)
    streaming: bool = False
    #: the seconds spent computing the digests, and each parameter's
    #: [copy to the host, sha256] seconds (on the digests' thread pool, so
    #: they overlap)
    digest_s: float = 0.0
    digest_times: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    #: flat weight key ("layers/wq") -> content digest, as the reference's
    #: ``engine/chunk_store.py:leaf_digest``; only with ``want_digests``
    digests: Dict[str, str] = dataclasses.field(default_factory=dict)

    def transfer_figures(self) -> List[Tuple[str, int, float]]:
        """``(kind, bytes, seconds)`` of the read and the copy windows, in
        the cost oracle's kinds (``utils/costs.py``); empty windows left
        out."""
        return [(kind, nb, sec) for kind, nb, sec in (
            ("coldload.read", self.bytes_read, self.read_s), ("coldload.h2d", self.bytes_h2d, self.h2d_s),
        ) if nb > 0 and sec > 0]

    def summary(self) -> Dict[str, Any]:
        """The numbers, without the digests and their times, and the
        load's rate."""
        out = {k: v for k, v in dataclasses.asdict(self).items() if k not in ("digests", "digest_times")}
        moved = self.bytes_h2d or self.bytes_read
        out["gb_per_s"] = moved / 1e9 / self.total_s if self.total_s > 0 else 0.0
        return out


def _shard_files(path: str) -> Tuple[str, List[str]]:
    """The checkpoint's shard layout, without reading tensor data:
    ``("safetensors" | "bin", ordered file list)``. An index file's
    declared shards must all be present, and only they are read."""
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    idx_path = os.path.join(path, "model.safetensors.index.json")
    if os.path.isfile(idx_path):
        with open(idx_path) as f:
            declared = sorted(set(json.load(f).get("weight_map", {}).values()))
        absent = [s for s in declared if s not in set(st_files)]
        if absent:
            raise FileNotFoundError(f"checkpoint {path!r} index declares shard files that are not present: {absent}")
        if declared:
            st_files = declared
    if st_files:
        return "safetensors", st_files
    bin_files = sorted(f for f in os.listdir(path) if f.startswith("pytorch_model") and f.endswith(".bin"))
    if not bin_files:
        raise FileNotFoundError(f"no *.safetensors or pytorch_model*.bin under {path!r}")
    return "bin", bin_files


class _Shard:
    """One opened shard file: its tensors' (dtype, shape) by name, and the
    tensors themselves as views of the mapped file."""

    def __init__(self, path: str, kind: str) -> None:
        self.path = path
        if kind == "safetensors":
            self._file = SafetensorsFile(path)
            self.specs = {n: (DTYPES[i.dtype], i.shape) for n, i in self._file.tensors.items()}
            self.get = self._file.get
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
            allowed = set(DTYPES.values())
            for name, t in sd.items():
                if t.dtype not in allowed:
                    raise ValueError(f"{path}: tensor {name!r} has dtype {t.dtype}; readable: {sorted(DTYPES)}")
            self.specs = {n: (t.dtype, tuple(t.shape)) for n, t in sorted(sd.items())}
            self.get = sd.__getitem__


#: per-layer HF suffix -> (the port's parameter, transpose?)
_LAYER_MAP: Dict[str, Tuple[str, bool]] = {
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "self_attn.q_norm.weight": ("q_norm", False),
    "self_attn.k_norm.weight": ("k_norm", False),
    "input_layernorm.weight": ("attn_norm", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
}

#: Mixtral's block-sparse FFN: an expert's suffix -> (the port's stack,
#: transpose?)
_EXPERT_MAP: Dict[str, Tuple[str, bool]] = {
    "w1.weight": ("w_gate", True),
    "w2.weight": ("w_down", True),
    "w3.weight": ("w_up", True),
}

#: harmless checkpoint extras (precomputed buffers, not weights)
_IGNORED_SUFFIXES = ("rotary_emb.inv_freq",)

_TOP_MAP: Dict[str, Tuple[str, bool]] = {
    "model.embed_tokens.weight": ("embed", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),
}


def _route(name: str, tie_embeddings: bool) -> Optional[Tuple[str, Optional[Tuple[int, ...]], bool]]:
    """An HF tensor name -> (the port's flat parameter name, the slice it
    writes — ``(layer,)``, ``(layer, expert)`` or None for a whole
    parameter — transpose?); None for tensors ignored on purpose
    (precomputed buffers, a tied lm_head); ValueError for anything
    unrecognized, an unknown expert tensor too — a silently dropped weight
    would serve wrong logits."""
    if name in _TOP_MAP:
        ours, transpose = _TOP_MAP[name]
        if ours == "lm_head" and tie_embeddings:
            return None  # tied: the forward reuses embed.T
        return ours, None, transpose
    if not name.startswith("model.layers."):
        if name.endswith(_IGNORED_SUFFIXES):
            return None
        raise ValueError(f"unrecognized checkpoint tensor {name!r}")
    idx, _, suffix = name[len("model.layers."):].partition(".")
    if not idx.isdigit():
        raise ValueError(f"unrecognized checkpoint tensor {name!r}")
    if suffix in _LAYER_MAP:
        ours, transpose = _LAYER_MAP[suffix]
        return f"layers.{ours}", (int(idx),), transpose
    if suffix == "block_sparse_moe.gate.weight":
        return "layers.router", (int(idx),), True
    if suffix.startswith("block_sparse_moe.experts."):
        e, _, w = suffix[len("block_sparse_moe.experts."):].partition(".")
        if not e.isdigit() or w not in _EXPERT_MAP:
            raise ValueError(f"unrecognized expert tensor {name!r}")
        ours, transpose = _EXPERT_MAP[w]
        return f"layers.{ours}", (int(idx), int(e)), transpose
    if suffix.endswith(_IGNORED_SUFFIXES):
        return None
    raise ValueError(f"unrecognized checkpoint tensor {name!r}")


def _want_slices(flat: str, shape: Tuple[int, ...], moe: bool) -> Set[tuple]:
    """Every slice the model expects a checkpoint tensor to write for this
    parameter: one per layer of a stacked one, one per layer and expert of
    an MoE expert stack, ``("*",)`` for the rest."""
    if moe and flat.startswith("layers.") and flat[len("layers."):] in EXPERT_WEIGHTS:
        return {(l, e) for l in range(shape[0]) for e in range(shape[1])}
    if flat.startswith("layers."):
        return {(l,) for l in range(shape[0])}
    return {("*",)}


@dataclasses.dataclass
class _Item:
    """One checkpoint tensor's route, checked: where it goes."""

    shard: _Shard
    name: str
    flat: str
    #: the slice it writes (``(layer,)`` or ``(layer, expert)``), None for
    #: a whole parameter
    index: Optional[Tuple[int, ...]]
    transpose: bool


def _plan(path: str, cfg: LlamaConfig) -> Tuple[List[_Shard], List[_Item]]:
    """Open every shard and route every tensor in it, checking each
    against the model's shapes, then that every slice of every parameter
    is written by some tensor — all before a byte of weight is copied."""
    kind, files = _shard_files(path)
    shapes = param_shapes(cfg)
    want = {k: _want_slices(k, s, is_moe(cfg)) for k, s in shapes.items()}
    staged: Dict[str, set] = {k: set() for k in shapes}
    shards, items = [], []
    for fname in files:
        sh = _Shard(os.path.join(path, fname), kind)
        shards.append(sh)
        for name, (_, shape) in sh.specs.items():
            route = _route(name, cfg.tie_embeddings)
            if route is None:
                continue
            flat, index, transpose = route
            if flat not in shapes or index is not None and {len(k) for k in want[flat]} != {len(index)}:
                # a tensor the config does not expect (biases with
                # attn_bias off, q_norm without qk_norm, an expert tensor
                # in a dense model or a dense FFN in an MoE one) would be
                # silently dropped weight otherwise
                raise ValueError(f"checkpoint tensor {name} has no place in the model config (architecture mismatch?)")
            if index is not None and any(i >= n for i, n in zip(index, shapes[flat])):
                raise ValueError(f"checkpoint tensor {name} has no place in the model config (slice {index} of "
                                 f"{shapes[flat][:len(index)]})")
            got = tuple(reversed(shape)) if transpose else tuple(shape)
            expect = shapes[flat][len(index):] if index is not None else shapes[flat]
            if got != tuple(expect):
                raise ValueError(f"{flat}: checkpoint shape {got} != model {tuple(expect)} (tensor {name})")
            staged[flat].add(("*",) if index is None else index)
            items.append(_Item(sh, name, flat, index, transpose))
    problems = []
    for flat in shapes:
        absent = want[flat] - staged[flat]
        if absent:
            problems.append(f"{flat}: {len(absent)}/{len(want[flat])} slices never staged (e.g. {sorted(absent)[:4]})")
    if problems:
        raise ValueError(f"checkpoint {path!r} is incomplete: " + "; ".join(sorted(problems)))
    return shards, items


class _Stager:
    """Moves host tensors into device tensors through two staging buffers:
    a chunk's host copy fills one buffer while the other's transfer runs,
    so at most two chunks' bytes are in flight. A chunk crosses in the
    checkpoint's dtype; its transpose and cast run on the device, in the
    copy into the destination. Both copies run on a copy stream of the
    stager's own on the destination card, after ``after`` (an event on the
    card's stream that wrote the destination last), and the events that
    time them and free a buffer are recorded there: the stager waits on
    its own events only, never on the card, so it may run while another
    thread captures a CUDA graph. On the CPU the same steps run with plain
    buffers, one after the other."""

    def __init__(self, device: torch.device, chunk_bytes: int, after: Optional[Any] = None) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self.chunk_bytes = chunk_bytes
        self.host = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=self.cuda) for _ in range(2)]
        self.dev = [torch.empty(chunk_bytes, dtype=torch.uint8, device=device) for _ in range(2)] if self.cuda else self.host
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        if after is not None:
            self.stream.wait_event(after)
        self.done: List[Optional[Any]] = [None, None]
        self.turn = 0
        #: (h2d start, h2d end, convert end) events per chunk
        self.marks: List[tuple] = []
        self.convert_s = 0.0

    def put(self, src: torch.Tensor, dest: torch.Tensor, transpose: bool) -> int:
        """``dest.copy_(src.T if transpose else src)``, chunked by rows of
        ``src``; returns the bytes staged."""
        faults.fire("coldload.h2d")
        rows = src.shape[0]
        row_bytes = src[0].numel() * src.element_size() if src.dim() > 1 else src.element_size()
        step = max(1, self.chunk_bytes // max(1, row_bytes))
        total = 0
        for r0 in range(0, rows, step):
            piece = src[r0 : r0 + step]
            out = dest[:, r0 : r0 + step] if transpose else dest[r0 : r0 + step]
            total += self._chunk(piece, out, transpose)
        return total

    def _chunk(self, piece: torch.Tensor, out: torch.Tensor, transpose: bool) -> int:
        b, self.turn = self.turn, 1 - self.turn
        n = piece.numel() * piece.element_size()
        if self.done[b] is not None:
            self.done[b].synchronize()  # the transfer that last read this buffer has landed
        host = self.host[b][:n].view(piece.dtype).view(piece.shape)
        host.copy_(piece)
        staged = self.dev[b][:n].view(piece.dtype).view(piece.shape)
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with torch.cuda.stream(self.stream):
                ev[0].record(self.stream)
                staged.copy_(host, non_blocking=True)
                ev[1].record(self.stream)
                out.copy_(staged.t() if transpose else staged)
                ev[2].record(self.stream)
            self.marks.append(ev)
            self.done[b] = ev[2]
        else:
            t1 = time.perf_counter()
            out.copy_(staged.t() if transpose else staged)
            self.convert_s += time.perf_counter() - t1
        return n

    def finish(self) -> None:
        """Wait for the last transfers (its own events); sum the device
        time of the converting copies."""
        if self.cuda:
            for ev in self.done:
                if ev is not None:
                    ev.synchronize()
            for _, e1, e2 in self.marks:
                self.convert_s += e1.elapsed_time(e2) / 1e3


def _mesh(model: "Llama | ShardedLlama") -> Optional[Mesh]:
    return model.mesh if isinstance(model, ShardedLlama) else None


def _local_index(index: Tuple[int, ...], spec, shape, mesh: Optional[Mesh], rank: int) -> Optional[Tuple[int, ...]]:
    """Where the checkpoint's slice ``index`` (the leading coordinates of
    a stacked parameter, ``(layer,)`` or ``(layer, expert)``) lies in rank
    ``rank``'s own parameter of ``shape``, whose leading dimensions
    ``spec`` splits; None when the rank holds none of it (an expert of
    another ``ep`` rank)."""
    out = []
    for i, axis, n in zip(index, spec, shape):
        if mesh is not None and axis is not None and mesh.shape[axis] > 1:
            i -= mesh.index(rank, axis) * n
            if not 0 <= i < n:
                return None
        out.append(i)
    return tuple(out)


def model_leaves(model: "Llama | ShardedLlama") -> Dict[str, torch.Tensor]:
    """Every parameter under the reference's flat key (``layers/wq``); a
    sharded model's slices joined on the host first."""
    if isinstance(model, ShardedLlama) and model.mesh.spans_processes:
        raise ValueError("a gang member holds only its own ranks' slices; the whole leaves are nowhere")
    ranks = held_ranks(model)
    specs = param_specs(model.cfg)
    whole = {}
    for flat in param_shapes(model.cfg):
        parts = [m.get_parameter(flat) for _, m in ranks]
        if len(parts) == 1 or all(a is None for a in specs[flat]):
            t = parts[0]
        else:
            t = join_for([p.to("cpu") for p in parts], specs[flat], model.mesh)
        whole[flat.replace(".", "/")] = t
    return whole


def model_digests(model: "Llama | ShardedLlama", times: Optional[Dict[str, List[float]]] = None) -> Dict[str, str]:
    """:func:`leaf_digest <..engine.chunk_store.leaf_digest>` of every
    parameter under the reference's flat key (:func:`model_leaves`),
    hashed on a thread pool (``chunk_store.digest_leaves``, which fills
    ``times``)."""
    return digest_leaves(model_leaves(model), times=times)


def estimate_param_bytes(cfg: LlamaConfig, transfer_quant: str = "off", hot_head: bool = True) -> int:
    """Bytes of the model's parameters, from the shapes only: in
    ``cfg.dtype``, a ``cfg.quantization`` int8 weight at its int8 and
    scale bytes (what an engine of ``cfg`` holds, a cold build's
    ``bytes_in``), or with ``transfer_quant`` ("int8"/"fp8",
    ``--sleep-quant``) the leaves a compressed staging quantizes at their
    payload and scale bytes, so a quantized stage is not over-reserved
    (the prefetch's budget check; a prefetch stages ``cfg`` unquantized)."""
    shapes = param_shapes(cfg)
    itemsize = cfg.dtype.itemsize
    mode = "" if transfer_quant in ("", "off") else transfer_quant
    if not mode:
        return sum(math.prod(s) * param_dtype(cfg, n).itemsize for n, s in shapes.items())
    return sum(
        quant_mod.payload_nbytes(shape, mode)
        if quant_mod.quant_eligible(flat.split("."), len(shape), hot_head) else math.prod(shape) * itemsize
        for flat, shape in shapes.items()
    )


@torch.no_grad()
def place_staged_params(
    params: Dict[str, Any], model: Llama, stats: Optional[LoadStats] = None, quant_metas: Optional[List[Any]] = None
) -> LoadStats:
    """Write a host weight tree (``{"embed": t, "layers": {"wq": t, ...}}``,
    the reference's nesting: what :func:`load_params` stages with
    ``place=False``, or what the model pool rebuilds from its chunk tiers)
    into ``model``'s parameters, in place: straight copies, on a copy
    stream of its own on the card, timed by CUDA events, and waited for
    by their last event. Every parameter must be there, in its shape and
    dtype. ``quant_metas`` (TransferQuant-or-None, aligned with the tree's
    leaves: a prefetch staged under ``--sleep-quant``) marks payloads:
    each is copied to the card and dequantized there into its parameter,
    on the same stream. Returns (or fills) the :class:`LoadStats`:
    ``h2d_s`` and ``bytes_h2d`` (the bytes that crossed)."""
    if quantized_names(model.cfg):
        if quant_metas is not None:
            raise ValueError("transfer-quantized staging and a quantized model do not mix (--sleep-quant is refused "
                             "with --quantization)")
        return _place_quantized(params, model, stats)
    if isinstance(model, ShardedLlama):
        raise ValueError("staged weights are placed on one device only")
    t_begin = time.perf_counter()
    st = stats if stats is not None else LoadStats()
    metas: Dict[str, Any] = {}
    if quant_metas is not None:
        paths = leaf_paths(params)
        if len(paths) != len(quant_metas):
            # never serve raw payloads as weights
            raise ValueError(f"quantized staging metadata ({len(quant_metas)}) does not align with the tree ({len(paths)} leaves)")
        metas = {".".join(p): m for p, m in zip(paths, quant_metas) if m is not None}
    pairs = []
    for flat, shape in param_shapes(model.cfg).items():
        node: Any = params
        for part in flat.split("."):
            if not isinstance(node, dict) or part not in node:
                raise ValueError(f"staged weights lack {flat.replace('.', '/')}")
            node = node[part]
        dest = model.get_parameter(flat)
        meta = metas.get(flat)
        dtype = TORCH_DTYPES[meta.orig_dtype] if meta is not None else node.dtype
        if tuple(node.shape) != tuple(shape) or dtype != dest.dtype:
            raise ValueError(f"staged {flat}: {tuple(node.shape)} {dtype}, the model holds {tuple(shape)} {dest.dtype}")
        pairs.append((dest, node, meta))

    def place(dest, node, meta, **kw) -> None:
        if meta is None:
            dest.copy_(node, **kw)
            return
        quant_mod.dequantize_into(dest, node, meta)  # on the current stream

    dev = model.device
    stage_sp = tracing.begin("coldload.place_staged", activate=False, leaves=len(pairs))
    h2d_sp = tracing.begin("coldload.h2d", parent=stage_sp.context(), activate=False,
                           leaves=len(pairs)) if stage_sp is not tracing.NOOP_SPAN else None
    if dev.type == "cuda":
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            begin.record(stream)
            for dest, node, meta in pairs:
                faults.fire("coldload.h2d")
                place(dest, node, meta, non_blocking=True)
            end.record(stream)
        end.synchronize()
        st.h2d_s = begin.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for dest, node, meta in pairs:
            faults.fire("coldload.h2d")
            place(dest, node, meta)
        st.h2d_s = time.perf_counter() - t0
    st.bytes_h2d = sum(
        n.numel() * n.element_size() + (m.scale_nbytes if m is not None else 0) for _, n, m in pairs
    )
    if h2d_sp is not None:
        h2d_sp.set(bytes=st.bytes_h2d, device_s=round(st.h2d_s, 6)).end()  # after the copies landed
    stage_sp.set(bytes=st.bytes_h2d).end()
    st.tensors = len(pairs)
    st.total_s = time.perf_counter() - t_begin
    return st


@torch.no_grad()
def _place_quantized(params: Dict[str, Any], model: "Llama | ShardedLlama", stats: Optional[LoadStats] = None
                     ) -> LoadStats:
    """A host weight tree in the model dtype (the unquantized staging)
    into a ``--quantization int8`` model, a leaf at a time
    (:func:`place_quantized_leaf`). The reference stages unquantized and
    quantizes once at the end (its ``hf.py:_quantize_and_repin``).
    ``bytes_h2d`` counts the bytes that crossed: the staged tree's."""
    t_begin = time.perf_counter()
    st = stats if stats is not None else LoadStats()
    cfg = model.cfg
    plain = dataclasses.replace(cfg, quantization="")
    moved = 0

    def node_of(flat: str) -> torch.Tensor:
        node: Any = params
        for part in flat.split("."):
            if not isinstance(node, dict) or part not in node:
                raise ValueError(f"staged weights lack {flat.replace('.', '/')}")
            node = node[part]
        return node

    t0 = time.perf_counter()
    for flat in param_shapes(plain):
        node = node_of(flat)
        faults.fire("coldload.h2d")
        moved += node.numel() * node.element_size()
        place_quantized_leaf(model, flat, node, sync=False)
    for _, m in held_ranks(model):
        if m.device.type == "cuda":
            # the copies and quantizations ran on the current stream: wait
            # for it alone, never the whole card
            torch.cuda.current_stream(m.device).synchronize()
    st.h2d_s = time.perf_counter() - t0
    st.bytes_h2d = moved
    st.tensors = len(param_shapes(plain))
    st.total_s = time.perf_counter() - t_begin
    return st


@torch.no_grad()
def place_quantized_leaf(model: "Llama | ShardedLlama", flat: str, node: torch.Tensor, sync: bool = True) -> None:
    """One unquantized host leaf ``flat`` into a ``--quantization int8``
    model: a plain leaf copied to every rank (its slice on a mesh), a
    quantized weight copied to rank 0's device one layer slice at a time
    and quantized there (:func:`~.quant.quantize_weight`, over the whole
    fan-in before any split), its ``q`` and ``s`` cut per rank by
    ``param_specs``. With ``sync`` it returns once the copies landed
    (the load's own events: never a wait on the whole card)."""
    ranks, mesh = held_ranks(model), _mesh(model)
    cfg = model.cfg
    plain = dataclasses.replace(cfg, quantization="")
    shape = param_shapes(plain)[flat]
    if tuple(node.shape) != tuple(shape) or node.dtype != cfg.dtype:
        raise ValueError(f"staged {flat}: {tuple(node.shape)} {node.dtype}, the model takes "
                         f"{tuple(shape)} {cfg.dtype}")
    dev = model.device
    if flat not in set(quantized_names(cfg)):
        for r, m in ranks:
            m.get_parameter(flat).copy_(shard_for(node, param_specs(plain)[flat], mesh, r), non_blocking=True)
    else:
        qspecs = param_specs(cfg)
        at = layer_at(model)
        stacked = len(shape) >= 3
        # one layer slice's specs: s splits over tp only where that is its output axis
        q_spec, s_spec = (qspecs[f"{flat}.{k}"][1:] if stacked else qspecs[f"{flat}.{k}"] for k in ("q", "s"))
        for i in range(shape[0] if stacked else 1):
            # a layer's slice ([in, out], or an MoE layer's [E, in, out],
            # quantized an expert at a time): never a whole stack in bf16
            # on the card
            w = (node[i] if stacked else node).to(dev, non_blocking=True)
            qd = quant_mod.quantize_weight(w)
            del w
            for r, m in ranks:
                if stacked and at(r, i) is None:
                    continue  # another pipeline stage's layer
                qp, sp = shard_for(qd["q"], q_spec, mesh, r), shard_for(qd["s"], s_spec, mesh, r)
                q_dst, s_dst = m.get_parameter(f"{flat}.q"), m.get_parameter(f"{flat}.s")
                (q_dst[at(r, i)] if stacked else q_dst).copy_(qp)
                (s_dst[at(r, i)] if stacked else s_dst).copy_(sp)
            del qd
    if sync:
        for _, m in ranks:
            if m.device.type == "cuda":
                torch.cuda.current_stream(m.device).synchronize()


def _resolve_workers(workers: Optional[int], shards: int) -> int:
    """``workers`` readers (None or <= 0: up to 8, one per CPU), never more
    than there are shards."""
    if workers is None or int(workers) <= 0:
        workers = min(8, os.cpu_count() or 1)
    return max(1, min(int(workers), shards))


def _run_readers(groups: List[List[_Item]], workers: int, read: Any, stop: threading.Event) -> None:
    """``read(items, worker)`` for each shard's items, on ``workers``
    threads that take the next shard as they finish one (in the calling
    thread for one worker). The first error stops the others (between
    tensors) and is raised; an abort raises :class:`LoadAborted`."""
    if workers == 1:
        for items in groups:
            read(items, 0)
        return
    todo: "queue.Queue[List[_Item]]" = queue.Queue()
    for items in groups:
        todo.put(items)

    def worker(index: int) -> None:
        try:
            while not stop.is_set():
                try:
                    items = todo.get_nowait()
                except queue.Empty:
                    return
                read(items, index)
        except BaseException:
            stop.set()  # fail fast: the siblings stop between tensors
            raise

    err: Optional[BaseException] = None
    with ThreadPoolExecutor(workers, thread_name_prefix="hf-load-read") as pool:
        futures = [pool.submit(worker, i) for i in range(workers)]
        for fut in futures:
            try:
                fut.result()
            except LoadAborted as e:
                err = err or e
            except BaseException as e:  # noqa: BLE001 — re-raised below
                # the first real error wins over a sibling's stop
                if err is None or isinstance(err, LoadAborted):
                    err = e
    if err is not None:
        raise err


def load_params(path: str, target: "Llama | ShardedLlama | LlamaConfig", *, stats: Optional[LoadStats] = None,
                **kw) -> "LoadStats | Dict[str, Any]":
    """:func:`_load_params` under a ``coldload.load`` span (not made
    current: the reader threads are handed its context, and each reads
    its shards under a ``coldload.read_shard``, the copies under a
    ``coldload.h2d`` that closes once they have landed)."""
    st = stats if stats is not None else LoadStats()
    with tracing.begin("coldload.load", activate=False, path=path, place=kw.get("place", True)) as sp:
        out = _load_params(path, target, stats=st, load_ctx=sp.context(), **kw)
        sp.set(shards=st.shards, workers=st.workers, streaming=st.streaming, bytes_read=st.bytes_read)
    return out


@torch.no_grad()
def _load_params(
    path: str,
    target: "Llama | ShardedLlama | LlamaConfig",
    *,
    workers: Optional[int] = None,
    place: bool = True,
    max_inflight_bytes: Optional[int] = None,
    abort_event: Optional[threading.Event] = None,
    throttle_bytes_per_s: float = 0.0,
    stats: Optional[LoadStats] = None,
    want_digests: bool = False,
    load_ctx: Optional[tracing.SpanContext] = None,
) -> "LoadStats | Dict[str, Any]":
    """The pipelined loader: the checkpoint under ``path``, read by
    ``workers`` threads over its shards (None or <= 0: up to 8, one per
    CPU, never more than shards).

    ``place=True`` (``target`` a model): written into the model's
    parameters in place (see the module docstring), every parameter tensor
    keeping its object and its address; each reader stages its tensors
    through a pair of pinned buffers of its own, the readers' buffers
    together at most ``max_inflight_bytes`` (default
    ``LOAD_INFLIGHT_BYTES``). The model's GLOBAL config decides the shapes;
    its parameters' dtype the cast. Returns the :class:`LoadStats`; with
    ``want_digests`` also each parameter's digest, hashed from the card
    after the load.

    ``place=False`` (``target`` a config, or a model for its config):
    staged on the host only, the prefetch's path — no CUDA tensor is
    created: a tree in the port's layout (``{"embed": t, "layers": {"wq":
    (L, in, out), ...}}``, the tree :func:`place_staged_params` takes) in
    ``cfg.dtype``, transposed and cast on the reader threads, in pinned
    memory when CUDA is available, so the later transfer is straight
    copies. With ``want_digests`` its digests
    are hashed from those host leaves into ``stats``. Returns the tree.

    Either way a checkpoint that does not fit the config or misses a slice
    raises before anything is read, and a shard its index declares but
    the directory lacks before that. ``abort_event`` (checked between
    tensors) raises :class:`LoadAborted`; ``throttle_bytes_per_s`` bounds
    the read rate; the ``coldload.read`` fault point fires at each shard,
    ``coldload.h2d`` at each tensor's transfer. ``stats`` (a LoadStats) is
    filled in place. The values staged do not depend on the schedule: any
    ``workers`` gives the same bits."""
    t_begin = time.perf_counter()
    st = stats if stats is not None else LoadStats()
    if place and not isinstance(target, (Llama, ShardedLlama)):
        raise TypeError("load_params(place=True) writes into a model; pass the model")
    cfg = target if isinstance(target, LlamaConfig) else target.cfg
    if quantized_names(cfg):
        # staged unquantized (the checkpoint's bf16), quantized once on the
        # card as it is placed (:func:`_place_quantized`), as the reference
        # does; a host tree (place=False) is the unquantized one
        cfg = dataclasses.replace(cfg, quantization="")
        if place:
            tree = _load_params(path, cfg, workers=workers, place=False, max_inflight_bytes=max_inflight_bytes,
                                abort_event=abort_event, throttle_bytes_per_s=throttle_bytes_per_s, stats=st,
                                load_ctx=load_ctx)
            read = (st.read_s, st.convert_s, st.bytes_read)
            _place_quantized(tree, target, st)
            st.read_s, st.convert_s, st.bytes_read = read
            st.total_s = time.perf_counter() - t_begin
            if want_digests:
                t_dig = time.perf_counter()
                st.digests = model_digests(target, times=st.digest_times)
                st.digest_s = time.perf_counter() - t_dig
            return st
    shards, items = _plan(path, cfg)
    groups = [[it for it in items if it.shard is sh] for sh in shards]
    groups = [g for g in groups if g]
    workers = _resolve_workers(workers, len(shards))
    st.workers, st.shards, st.streaming = workers, len(shards), place
    stop = threading.Event()
    mu = threading.Lock()
    read_end = [t_begin]
    counts = {"bytes": 0, "tensors": 0, "convert_s": 0.0}

    def check_abort() -> None:
        if stop.is_set() or (abort_event is not None and abort_event.is_set()):
            raise LoadAborted(f"load of {path!r} aborted")

    def account(nbytes: int, convert_s: float = 0.0) -> None:
        with mu:
            counts["bytes"] += nbytes
            counts["convert_s"] += convert_s
            total = counts["bytes"]
        if throttle_bytes_per_s and throttle_bytes_per_s > 0:
            ahead = total / throttle_bytes_per_s - (time.perf_counter() - t_begin)
            while ahead > 0 and not stop.is_set() and not (abort_event is not None and abort_event.is_set()):
                time.sleep(min(ahead, 0.2))
                ahead = total / throttle_bytes_per_s - (time.perf_counter() - t_begin)

    def done_reading() -> None:
        with mu:
            counts["tensors"] += 1
            read_end[0] = max(read_end[0], time.perf_counter())

    if not place:
        try:
            tree = _stage_host(cfg, groups, workers, stop, check_abort, account, done_reading, load_ctx)
        finally:
            # valid on the error paths too: an aborted prefetch reports
            # what it read
            st.read_s = read_end[0] - t_begin
            st.convert_s = counts["convert_s"]
            st.bytes_read, st.tensors = counts["bytes"], counts["tensors"]
        if want_digests:
            t_dig = time.perf_counter()
            st.digests = digest_leaves(tree, times=st.digest_times)
            st.digest_s = time.perf_counter() - t_dig
        st.total_s = time.perf_counter() - t_begin
        from ..engine.chunk_store import unflatten_tree

        return unflatten_tree(tree)

    model = target
    ranks, mesh = held_ranks(model), _mesh(model)
    pspecs = param_specs(cfg)
    devices = list(dict.fromkeys(m.device for _, m in ranks))
    # a staging buffer holds the in-flight bytes over (2 x readers), or the
    # largest tensor when that is smaller, and at least one row of the widest
    specs = [it.shard.specs[it.name] for it in items]
    largest = max((dt.itemsize * math.prod(shape) for dt, shape in specs), default=1)
    widest = max((dt.itemsize * math.prod(shape[1:]) for dt, shape in specs), default=1)
    inflight = int(max_inflight_bytes or LOAD_INFLIGHT_BYTES)
    chunk = max(widest, min(inflight // (2 * workers), largest))
    # the copy streams start after whatever the card's stream wrote into
    # the destination before (an arena's zero fill)
    begun: Dict[torch.device, Any] = {}
    for d in devices:
        if d.type == "cuda":
            begun[d] = torch.cuda.Event(enable_timing=True)
            begun[d].record(torch.cuda.current_stream(d))
    stagers: List[Dict[torch.device, _Stager]] = [{} for _ in range(workers)]

    def read(group: List[_Item], index: int) -> None:
        with _shard_span(load_ctx, group):
            read_shard(group, index)

    def read_shard(group: List[_Item], index: int) -> None:
        faults.fire("coldload.read")
        mine = stagers[index]
        for it in group:
            check_abort()
            src = it.shard.get(it.name)
            spec = pspecs[it.flat]
            rest = spec[len(it.index or ()):]  # the slice's own dimensions
            if it.transpose:  # the checkpoint holds the slice as (out, in)
                rest = rest[::-1]
            n = 0
            for r, m in ranks:
                dest = m.get_parameter(it.flat)
                if it.index is not None:
                    at = _local_index(it.index, spec, dest.shape, mesh, r)
                    if at is None:
                        continue
                    dest = dest[at]
                piece = shard_for(src, rest, mesh, r)
                if m.device not in mine:
                    mine[m.device] = _Stager(m.device, chunk, begun.get(m.device))
                n += mine[m.device].put(piece, dest, it.transpose)
            del src
            done_reading()
            account(n)

    # the copies' span: from the first read to the last copy landed (the
    # copies are issued as the readers stage; device_s is their window on
    # the card)
    h2d_sp = tracing.begin("coldload.h2d", parent=load_ctx, activate=False) if load_ctx is not None else None
    try:
        _run_readers(groups, workers, read, stop)
    finally:
        # whatever was issued lands before the buffers go, even on an error
        for mine in stagers:
            for s in mine.values():
                s.finish()
        if h2d_sp is not None:
            h2d_sp.set(bytes=counts["bytes"], leaves=counts["tensors"]).end()
        st.read_s = read_end[0] - t_begin
        st.bytes_read = st.bytes_h2d = counts["bytes"]
        st.tensors = counts["tensors"]
    all_stagers = [s for mine in stagers for s in mine.values()]
    st.convert_s = sum(s.convert_s for s in all_stagers)
    for d, ev in begun.items():
        # the device's transfer window: from the first chunk issued to the
        # last landed, on any reader's stream
        marks = [m for s in all_stagers if s.device == d for m in s.marks]
        if marks:
            first = min(ev.elapsed_time(m[0]) for m in marks)
            last = max(ev.elapsed_time(m[2]) for m in marks)
            st.h2d_s = max(st.h2d_s, (last - first) / 1e3)
            st.overlap_s = max(st.overlap_s, min(st.read_s, last / 1e3) - max(0.0, first / 1e3))
    del stagers, all_stagers, shards, items, groups
    if want_digests:
        t_dig = time.perf_counter()
        st.digests = model_digests(model, times=st.digest_times)
        st.digest_s = time.perf_counter() - t_dig
    st.total_s = time.perf_counter() - t_begin
    st.overlap_frac = st.overlap_s / st.total_s if st.total_s > 0 else 0.0
    return st


def _shard_span(load_ctx, group: List[_Item]):
    """A reader's ``coldload.read_shard`` span, under the load's span
    (handed over: a reader thread has no context of its own)."""
    if load_ctx is None:
        return tracing.NOOP_SPAN
    return tracing.begin("coldload.read_shard", parent=load_ctx, activate=False,
                         shard=os.path.basename(group[0].shard.path) if group else "")


def _stage_host(cfg: LlamaConfig, groups, workers, stop, check_abort, account, done_reading,
                load_ctx=None) -> Dict[str, torch.Tensor]:
    """:func:`load_params`'s host-only staging: every parameter a host
    tensor in ``cfg.dtype`` and the port's layout, keyed ``layers/wq``,
    each checkpoint tensor transposed and cast into its slice by a reader
    thread."""
    pin = torch.cuda.is_available()
    bufs = {flat: torch.empty(shape, dtype=cfg.dtype, pin_memory=pin) for flat, shape in param_shapes(cfg).items()}

    def read(group: List[_Item], index: int) -> None:
        with _shard_span(load_ctx, group):
            read_shard(group, index)

    def read_shard(group: List[_Item], index: int) -> None:
        faults.fire("coldload.read")
        for it in group:
            check_abort()
            src = it.shard.get(it.name)
            dest = bufs[it.flat] if it.index is None else bufs[it.flat][it.index]
            t0 = time.perf_counter()
            dest.copy_(src.t() if it.transpose else src)
            dt = time.perf_counter() - t0
            n = src.numel() * src.element_size()
            del src
            done_reading()
            account(n, dt)

    _run_readers(groups, workers, read, stop)
    return {flat.replace(".", "/"): t for flat, t in bufs.items()}
