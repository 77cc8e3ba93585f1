"""Hugging Face checkpoint import: ``config.json`` and the weight shards
of a model directory, written into a model's own tensors.

Port of ``llm_d_fast_model_actuation_tpu/models/hf.py``, dense families
only: ``LlamaForCausalLM`` (Llama 2/3, TinyLlama), ``MistralForCausalLM``,
``Qwen2ForCausalLM`` (q/k/v biases), ``Qwen3ForCausalLM`` (per-head q/k
norms) and ``GemmaForCausalLM``; ``MixtralForCausalLM`` is refused by name
(MoE is not ported). The config, eos, shard-layout, routing and
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
  * each tensor crosses to the device in its own dtype, in row chunks
    through two pinned staging buffers (at most ``LOAD_INFLIGHT_BYTES`` on
    the host at a time, never the checkpoint), and is transposed and cast
    on the device into its destination. fp32 -> bf16 is round to nearest
    even, the bits of the reference's host cast;
  * on a tensor-parallel model each rank's slice is cut from the mapped
    tensor by ``llama.param_tp_dims``, as ``models/convert.py`` cuts it.

HF stores per-layer ``model.layers.{i}.<name>.weight`` as (out, in); the
port's stacked layouts are (L, in, out), so a layer's tensor is written
transposed into slice ``i``. The rotate-half RoPE layout and Gemma's
zero-centred norms copy verbatim (``norm_offset``, ``embed_scale``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from ..engine.chunk_store import digest_leaves
from ..parallel.mesh import shard
from .llama import Llama, LlamaConfig, ShardedLlama, param_shapes, param_tp_dims
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
}

#: architectures the reference serves and the port does not yet
UNPORTED_ARCHITECTURES = {"MixtralForCausalLM": "MoE is not ported yet (ROADMAP queue 1 item 16)"}

#: host bytes in flight while loading: two staging buffers of half each
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
    ``max_seq_len``, ...)."""
    hf = _read_config(path)
    archs = hf.get("architectures") or []
    arch = archs[0] if archs else "LlamaForCausalLM"
    if arch in UNPORTED_ARCHITECTURES:
        raise ValueError(f"architecture {arch!r} is not supported by the port: {UNPORTED_ARCHITECTURES[arch]}")
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
    fields.update(overrides)
    return dataclasses.replace(LlamaConfig(), **fields)


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


@dataclasses.dataclass
class LoadStats:
    """A load's phases, as :func:`load_params` returns them, with the
    reference's field names. ``read_s``: host time copying the
    mapped checkpoint bytes into the staging buffers (the disk read, as
    pages are first touched there); ``h2d_s`` and ``convert_s``: device
    time of the transfers and of the on-device transpose/cast copies (CUDA
    events; host time on the CPU); ``total_s``: wall time of the call."""

    total_s: float = 0.0
    read_s: float = 0.0
    convert_s: float = 0.0
    h2d_s: float = 0.0
    #: checkpoint bytes read (a tensor once per rank slice it feeds)
    bytes_read: int = 0
    #: bytes moved host -> device, in the checkpoint's dtypes
    bytes_h2d: int = 0
    shards: int = 0
    tensors: int = 0
    #: of total_s, the seconds spent computing the digests, and each
    #: parameter's [copy to the host, sha256] seconds (on the digests'
    #: thread pool, so they overlap)
    digest_s: float = 0.0
    digest_times: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    #: flat weight key ("layers/wq") -> content digest, as the reference's
    #: ``engine/chunk_store.py:leaf_digest``; only with ``want_digests``
    digests: Dict[str, str] = dataclasses.field(default_factory=dict)

    def summary(self) -> Dict[str, Any]:
        """The numbers, without the digests and their times, and the
        load's rate."""
        out = {k: v for k, v in dataclasses.asdict(self).items() if k not in ("digests", "digest_times")}
        out["gb_per_s"] = self.bytes_h2d / 1e9 / self.total_s if self.total_s > 0 else 0.0
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

#: harmless checkpoint extras (precomputed buffers, not weights)
_IGNORED_SUFFIXES = ("rotary_emb.inv_freq",)

_TOP_MAP: Dict[str, Tuple[str, bool]] = {
    "model.embed_tokens.weight": ("embed", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),
}


def _route(name: str, tie_embeddings: bool) -> Optional[Tuple[str, Optional[int], bool]]:
    """An HF tensor name -> (the port's flat parameter name, layer or
    None, transpose?); None for tensors ignored on purpose (precomputed
    buffers, a tied lm_head); ValueError for anything unrecognized — a
    silently dropped weight would serve wrong logits."""
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
        return f"layers.{ours}", int(idx), transpose
    if suffix.endswith(_IGNORED_SUFFIXES):
        return None
    raise ValueError(f"unrecognized checkpoint tensor {name!r}")


def _want_slices(flat: str, shape: Tuple[int, ...]) -> Set[tuple]:
    """Every slice the model expects a checkpoint tensor to write for this
    parameter: one per layer of a stacked one, ``("*",)`` for the rest."""
    if flat.startswith("layers."):
        return {(l,) for l in range(shape[0])}
    return {("*",)}


@dataclasses.dataclass
class _Item:
    """One checkpoint tensor's route, checked: where it goes."""

    shard: _Shard
    name: str
    flat: str
    layer: Optional[int]
    transpose: bool


def _plan(path: str, cfg: LlamaConfig) -> Tuple[List[_Shard], List[_Item]]:
    """Open every shard and route every tensor in it, checking each
    against the model's shapes, then that every slice of every parameter
    is written by some tensor — all before a byte of weight is copied."""
    kind, files = _shard_files(path)
    shapes = param_shapes(cfg)
    want = {k: _want_slices(k, s) for k, s in shapes.items()}
    staged: Dict[str, set] = {k: set() for k in shapes}
    shards, items = [], []
    for fname in files:
        sh = _Shard(os.path.join(path, fname), kind)
        shards.append(sh)
        for name, (_, shape) in sh.specs.items():
            route = _route(name, cfg.tie_embeddings)
            if route is None:
                continue
            flat, layer, transpose = route
            if flat not in shapes:
                # a tensor the config does not expect (biases with
                # attn_bias off, q_norm without qk_norm, a layer past the
                # stack) would be silently dropped weight otherwise
                raise ValueError(f"checkpoint tensor {name} has no place in the model config (architecture mismatch?)")
            if layer is not None and layer >= shapes[flat][0]:
                raise ValueError(f"checkpoint tensor {name} has no place in the model config (layer {layer} of "
                                 f"{shapes[flat][0]})")
            got = tuple(reversed(shape)) if transpose else tuple(shape)
            expect = shapes[flat][1:] if layer is not None else shapes[flat]
            if got != tuple(expect):
                raise ValueError(f"{flat}: checkpoint shape {got} != model {tuple(expect)} (tensor {name})")
            staged[flat].add(("*",) if layer is None else (layer,))
            items.append(_Item(sh, name, flat, layer, transpose))
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
    copy into the destination. Both copies run on the destination card's
    current stream, whichever card is current, so the events that time
    them and free a buffer are recorded there. On the CPU the same steps
    run with plain buffers, one after the other."""

    def __init__(self, device: torch.device, chunk_bytes: int) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self.chunk_bytes = chunk_bytes
        self.host = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=self.cuda) for _ in range(2)]
        self.dev = [torch.empty(chunk_bytes, dtype=torch.uint8, device=device) for _ in range(2)] if self.cuda else self.host
        self.done: List[Optional[Any]] = [None, None]
        self.turn = 0
        #: (h2d start, h2d end, convert end) events per chunk
        self.marks: List[tuple] = []
        self.read_s = self.h2d_s = self.convert_s = 0.0

    def put(self, src: torch.Tensor, dest: torch.Tensor, transpose: bool) -> int:
        """``dest.copy_(src.T if transpose else src)``, chunked by rows of
        ``src``; returns the bytes staged."""
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
        t0 = time.perf_counter()
        host = self.host[b][:n].view(piece.dtype).view(piece.shape)
        host.copy_(piece)
        t1 = time.perf_counter()
        self.read_s += t1 - t0
        staged = self.dev[b][:n].view(piece.dtype).view(piece.shape)
        if self.cuda:
            stream = torch.cuda.current_stream(self.device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record(stream)
            staged.copy_(host, non_blocking=True)
            ev[1].record(stream)
            out.copy_(staged.t() if transpose else staged)
            ev[2].record(stream)
            self.marks.append(ev)
            self.done[b] = ev[2]
        else:
            out.copy_(staged.t() if transpose else staged)
            self.convert_s += time.perf_counter() - t1
        return n

    def finish(self) -> None:
        """Wait for the last transfers; sum the device times."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
            for e0, e1, e2 in self.marks:
                self.h2d_s += e0.elapsed_time(e1) / 1e3
                self.convert_s += e1.elapsed_time(e2) / 1e3


def _ranks(model: "Llama | ShardedLlama") -> List[Llama]:
    return list(model.ranks) if isinstance(model, ShardedLlama) else [model]


def _param(m: Llama, flat: str) -> torch.Tensor:
    return m.layers[flat[len("layers."):]] if flat.startswith("layers.") else m.get_parameter(flat)


def model_digests(model: "Llama | ShardedLlama", times: Optional[Dict[str, List[float]]] = None) -> Dict[str, str]:
    """:func:`leaf_digest <..engine.chunk_store.leaf_digest>` of every
    parameter under the reference's flat key (``layers/wq``); a sharded
    model's slices joined first. The leaves are copied to the host and
    hashed on a thread pool (``chunk_store.digest_leaves``, which fills
    ``times``)."""
    ranks = _ranks(model)
    dims = param_tp_dims(model.cfg)
    whole = {}
    for flat in param_shapes(model.cfg):
        parts = [_param(m, flat) for m in ranks]
        d = dims[flat]
        t = parts[0] if d is None or len(parts) == 1 else torch.cat([p.to("cpu") for p in parts], dim=d)
        whole[flat.replace(".", "/")] = t
    return digest_leaves(whole, times=times)


@torch.no_grad()
def place_staged_params(params: Dict[str, Any], model: Llama) -> None:
    """Write a host weight tree (``{"embed": t, "layers": {"wq": t, ...}}``,
    the reference's nesting, as the model pool rebuilds it from its chunk
    tiers) into ``model``'s parameters, in place. Every parameter must be
    there, in its shape and dtype."""
    if isinstance(model, ShardedLlama):
        raise ValueError("staged weights are placed on one device only")
    for flat, shape in param_shapes(model.cfg).items():
        node: Any = params
        for part in flat.split("."):
            if not isinstance(node, dict) or part not in node:
                raise ValueError(f"staged weights lack {flat.replace('.', '/')}")
            node = node[part]
        dest = _param(model, flat)
        if tuple(node.shape) != tuple(shape) or node.dtype != dest.dtype:
            raise ValueError(f"staged {flat}: {tuple(node.shape)} {node.dtype}, the model holds {tuple(shape)} {dest.dtype}")
        dest.copy_(node)


@torch.no_grad()
def load_params(
    path: str,
    model: "Llama | ShardedLlama",
    *,
    want_digests: bool = False,
) -> LoadStats:
    """Write the checkpoint under ``path`` into ``model``'s parameters, in
    place (see the module docstring): every parameter tensor keeps its
    object and its address. The model's GLOBAL config decides the shapes;
    its parameters' dtype the cast. Raises before writing anything if the
    checkpoint does not fit the config or misses a slice. Returns the
    :class:`LoadStats`; with ``want_digests`` also each parameter's
    digest."""
    t_begin = time.perf_counter()
    st = LoadStats()
    cfg = model.cfg
    shards, items = _plan(path, cfg)
    ranks = _ranks(model)
    tp = len(ranks)
    dims = param_tp_dims(cfg)
    # a staging buffer holds half the in-flight bytes, or the largest
    # tensor when that is smaller, and at least one row of the widest
    specs = [it.shard.specs[it.name] for it in items]
    largest = max((dt.itemsize * math.prod(shape) for dt, shape in specs), default=1)
    widest = max((dt.itemsize * math.prod(shape[1:]) for dt, shape in specs), default=1)
    chunk = max(widest, min(LOAD_INFLIGHT_BYTES // 2, largest))
    stagers: Dict[torch.device, _Stager] = {}
    for m in ranks:
        if m.device not in stagers:
            stagers[m.device] = _Stager(m.device, chunk)
    for it in items:
        src = it.shard.get(it.name)
        d = dims[it.flat]
        if d is not None and it.layer is not None:
            d -= 1  # the dimension within one layer's slice
        for r, m in enumerate(ranks):
            dest = _param(m, it.flat)
            if it.layer is not None:
                dest = dest[it.layer]
            if tp > 1 and d is not None:
                piece = shard(src, (dest.dim() - 1 - d) if it.transpose else d, r, tp)
            else:
                piece = src
            n = stagers[m.device].put(piece, dest, it.transpose)
            st.bytes_read += n
            st.bytes_h2d += n
        st.tensors += 1
        del src
    for s in stagers.values():
        s.finish()
        st.read_s += s.read_s
        st.h2d_s += s.h2d_s
        st.convert_s += s.convert_s
    st.shards = len(shards)
    del stagers, shards, items
    if want_digests:
        t_dig = time.perf_counter()
        st.digests = model_digests(model, times=st.digest_times)
        st.digest_s = time.perf_counter() - t_dig
    st.total_s = time.perf_counter() - t_begin
    return st

