"""Ring attention: causal attention over a sequence split across ranks.

Port of ``llm_d_fast_model_actuation_tpu/ops/ring_attention.py``.
Long-context training splits the SEQUENCE axis over the mesh's ``sp``
axis. Gathering the whole sequence's K/V on every rank would undo the
split; ring attention instead passes the K/V chunks around the ``sp``
ring (``Mesh.ring_shift``, the reference's ``ppermute``) while every rank
folds each chunk into online-softmax partial results for its own Q
chunk, so a rank holds O(S/n) of the sequence. The reference's ring
crosses the TPU's chip-to-chip links; here the ranks are one process's,
and a shift is a copy between the ranks' devices (none when they share
one).

Semantics are those of the reference's ring, detail for detail: the
query scaled in f32 and rounded back to ``q.dtype`` before its product
with K, the causal and ``seq_lens`` masks on global positions, fp32
softmax state, GQA grouped without repeating K/V, n fold-then-shift
steps, the ``l > 0`` guard, and at ``sp = 1`` the dense function. It is
plain torch, so autograd differentiates it, as ``jax.grad`` goes through
the reference's ``shard_map``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .attention import NEG_INF, dense_causal_attention


def chunk_attend(q, k, v, q_pos, k_pos, seq_lens, m, l, acc) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one K/V chunk into the online-softmax state of the local Q
    (the reference's ``_chunk_attend``).

    q: [b, Cq, h, d]   k/v: [b, Ck, kvh, d]   q_pos: [Cq]  k_pos: [Ck]
    m, l: [b, kvh, g, Cq, 1]   acc: [b, kvh, g, Cq, d]
    """
    b, cq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = (q.float() * d**-0.5).to(q.dtype)
    qg = qg.reshape(b, cq, kvh, g, d)
    logits = torch.einsum("bqngd,bknd->bngqk", qg.float(), k.float())  # [b, kvh, g, Cq, Ck]
    causal = q_pos[:, None] >= k_pos[None, :]  # [Cq, Ck]
    valid = k_pos[None, :] < seq_lens[:, None]  # [b, Ck]
    mask = causal[None, :, :] & valid[:, None, :]  # [b, Cq, Ck]
    logits = torch.where(mask[:, None, None, :, :], logits, torch.full((), NEG_INF, device=q.device))

    m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    probs = torch.exp(logits - m_new)
    l_new = l * alpha + probs.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bngqk,bknd->bngqd", probs.to(v.dtype).float(), v.float())
    acc_new = acc * alpha + pv
    return m_new, l_new, acc_new


def ring_prefill_attention(
    q: Sequence[torch.Tensor],  # per rank [b, s/n, heads, d], roped: its chunk of the sequence
    k: Sequence[torch.Tensor],  # per rank [b, s/n, kv_heads, d]
    v: Sequence[torch.Tensor],  # per rank [b, s/n, kv_heads, d]
    seq_lens: Sequence[torch.Tensor],  # per rank [b] int: global valid lengths
    mesh,
    axis_name: str = "sp",
) -> List[torch.Tensor]:
    """Causal prefill attention with the sequence split over
    ``axis_name`` of ``mesh`` (``parallel/mesh.py:Mesh``): every argument
    is one tensor per rank, the rank at coordinate i along the axis
    holding positions ``i*chunk .. (i+1)*chunk - 1``. K/V go round the
    ring, Q stays put. Returns each rank's output chunk ``[b, s/n, heads,
    d]`` in ``q``'s dtype."""
    n = mesh.shape[axis_name]
    if n == 1:
        return [dense_causal_attention(q[r], k[r], v[r], seq_lens[r]) for r in range(mesh.size)]
    b, chunk, h, d = q[0].shape
    kvh = k[0].shape[2]
    g = h // kvh
    idx = [mesh.index(r, axis_name) for r in range(mesh.size)]
    ar = {dev: torch.arange(chunk, device=dev) for dev in mesh.distinct_devices()}
    q_pos = [idx[r] * chunk + ar[q[r].device] for r in range(mesh.size)]
    lens = [sl.to(q[r].device) for r, sl in enumerate(seq_lens)]

    def zeros(r, last, fill=0.0):
        return torch.full((b, kvh, g, chunk, last), fill, dtype=torch.float32, device=q[r].device)

    m = [zeros(r, 1, NEG_INF) for r in range(mesh.size)]
    l = [zeros(r, 1) for r in range(mesh.size)]
    acc = [zeros(r, d) for r in range(mesh.size)]
    kc, vc = list(k), list(v)
    for t in range(n):
        for r in range(mesh.size):
            src = (idx[r] - t) % n
            k_pos = src * chunk + ar[q[r].device]
            m[r], l[r], acc[r] = chunk_attend(q[r], kc[r], vc[r], q_pos[r], k_pos, lens[r], m[r], l[r], acc[r])
        # hand the K/V chunk to the next rank of the ring
        kc, vc = mesh.ring_shift(kc, axis_name), mesh.ring_shift(vc, axis_name)
    out = []
    for r in range(mesh.size):
        pos = l[r] > 0
        o = torch.where(pos, acc[r] / torch.where(pos, l[r], torch.ones((), device=l[r].device)),
                        torch.zeros((), device=l[r].device))
        # [b, kvh, g, cq, d] -> [b, cq, h, d]
        out.append(o.permute(0, 3, 1, 2, 4).reshape(b, chunk, h, d).to(q[r].dtype))
    return out
