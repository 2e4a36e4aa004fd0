"""Plain PyTorch versions of the CUDA kernels: what runs on the CPU, and
what the kernels are held against on the card."""

from __future__ import annotations

import math

import torch

from repro_torch.core import entropy
from repro_torch.kernels.flash_attention import (
    check_bwd_shapes, check_shapes, scale_query)
from repro_torch.kernels.tree_infer import (
    COL_ATTR, COL_CHILD0, COL_CLASS, COL_HEAVY, COL_NCHILD, COL_SPLIT)


def histogram_scatter(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                      slot: torch.Tensor, *, n_slots: int, n_bins: int,
                      n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain histogram's (index, weight) pair of every (case,
    attribute): flat offsets into a (K+1, A, B+1, C) array, bin B for
    unknown values (-1), a dump row K for slot -1."""
    n, a_dim = x.shape
    k, b, c = n_slots, n_bins, n_classes
    slot_safe = torch.where(slot >= 0, slot, k).long()
    bin_safe = torch.where(x >= 0, x, b).long()
    attr = torch.arange(a_dim, device=x.device)
    flat = ((slot_safe[:, None] * a_dim + attr[None, :]) * (b + 1)
            + bin_safe) * c + y.long()[:, None]
    return (flat.reshape(-1),
            w.to(torch.float32)[:, None].expand(n, a_dim).reshape(-1))


def frontier_histogram_ref(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                           slot: torch.Tensor, *, n_slots: int, n_bins: int,
                           n_classes: int) -> torch.Tensor:
    """(K, A, B+1, C) weighted counts via one flat ``index_add_`` of
    :func:`histogram_scatter`'s pairs; the dump row is cut off."""
    kw = dict(n_slots=n_slots, n_bins=n_bins, n_classes=n_classes)
    flat, src = histogram_scatter(x, y, w, slot, **kw)
    shape = (n_slots + 1, x.shape[1], n_bins + 1, n_classes)
    hist = torch.zeros((math.prod(shape),), dtype=torch.float32,
                       device=x.device)
    hist.index_add_(0, flat, src)
    return hist.reshape(shape)[:n_slots]


def split_gain_ref(hist: torch.Tensor, total_w: torch.Tensor, attr_is_cont,
                   n_bins, *, min_objs: float = 2.0, criterion: str = "gain"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(score, split_bin) of shape (K, A) via the shared scorer."""
    return entropy.gains_from_histogram(
        hist, total_w=total_w, attr_is_cont=attr_is_cont, n_bins=n_bins,
        min_objs=min_objs, criterion=criterion)


def forest_predict_ref(node_tab: torch.Tensor, x_bins: torch.Tensor,
                       attr_is_cont: torch.Tensor, *, max_depth: int
                       ) -> torch.Tensor:
    """(T, N) int32 leaf classes: ``max_depth`` steps of
    :func:`repro_torch.core.tree.descend_once` over all T trees at once,
    gathering the (T, M) table columns at a (T, N) node tensor.  An
    attribute at or above A reads as unknown, as the JAX package's
    ``descend_once`` does (its out-of-range gather fills a negative
    value)."""
    t_dim = node_tab.shape[0]
    n, a_dim = x_bins.shape
    col = node_tab.unbind(-1)
    node = torch.zeros((t_dim, n), dtype=torch.int64, device=x_bins.device)
    row0 = torch.arange(n, device=x_bins.device)[None, :] * a_dim
    x_flat = x_bins.reshape(-1)
    for _ in range(max_depth):
        attr = col[COL_ATTR].gather(1, node)
        nchild = col[COL_NCHILD].gather(1, node)
        inside = attr < a_dim
        a_safe = torch.clamp(attr, 0, max(a_dim - 1, 0)).long()
        b = torch.where(inside, x_flat[row0 + a_safe], -1)
        child_cont = torch.where(b <= col[COL_SPLIT].gather(1, node), 0, 1)
        child = torch.where(attr_is_cont[a_safe], child_cont, b)
        # Unknown value: follow the heaviest child, as the build routed it.
        child = torch.where(b < 0, col[COL_HEAVY].gather(1, node), child)
        child = torch.minimum(torch.clamp_min(child, 0),
                              torch.clamp_min(nchild - 1, 0))
        nxt = col[COL_CHILD0].gather(1, node) + child
        node = torch.where(nchild == 0, node, nxt.long())
    return col[COL_CLASS].gather(1, node)


#: The finite mask value of the JAX attention (never -inf: see the kernel).
MASKED = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, softcap: float = 0.0,
                        q_chunk: int = 1024, return_lse: bool = False):
    """(B, Sq, H, D) causal GQA attention, the function of the flash kernel:
    q scaled in its dtype, then :func:`flash_attention_fwd_ref`.  With
    ``return_lse`` also each row's log-sum-exp (B, H, Sq), f32."""
    check_shapes(q, k, v, window=window, softcap=softcap)
    out, lse = flash_attention_fwd_ref(scale_query(q), k, v, window=window,
                                       softcap=softcap, q_chunk=q_chunk)
    return (out, lse) if return_lse else out


def _live_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, sk: int,
               window: int) -> torch.Tensor:
    """The (q, k) mask of the JAX ``_attn_mask``: causal, the window, and
    keys before Sk."""
    mask = (q_pos[:, None] >= k_pos[None, :]) & (k_pos < sk)[None, :]
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return mask


def flash_attention_fwd_ref(qs: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: int = 0,
                            softcap: float = 0.0, q_chunk: int = 1024
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``flash_attention.flash_attention_fwd`` on q
    already scaled: logits in f32 (softcapped, masked with -1e30), an exact
    softmax over each row's live keys, ``acc / max(l, 1e-30)`` in q's dtype,
    and each row's ``lse = m + log(max(l, 1e-30))`` (natural log, f32,
    (B, H, Sq); ``m + log(l)`` of the JAX ``_flash_fwd``'s stats).  Rows go
    ``q_chunk`` at a time, and each chunk reads only the keys its causal
    window can reach, so the logits stay small."""
    check_shapes(qs, k, v, window=window, softcap=softcap)
    b, sq, h, d = qs.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = qs.reshape(b, sq, kv, g, d).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((b, sq, h, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((b, kv, g, sq), dtype=torch.float32, device=qs.device)
    for s0 in range(0, sq, q_chunk):
        s1 = min(s0 + q_chunk, sq)
        k0 = max(s0 - window + 1, 0) if window > 0 else 0
        q_pos = torch.arange(s0, s1, device=qs.device)
        k_pos = torch.arange(k0, s1, device=qs.device)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qf[:, s0:s1], kf[:, k0:s1])
        if softcap > 0:
            logits = torch.tanh(logits / softcap) * softcap
        logits = torch.where(_live_mask(q_pos, k_pos, sk, window), logits,
                             MASKED)
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        acc = torch.einsum("bkgqs,bskd->bqkgd", p, vf[:, k0:s1])
        l_sum = torch.clamp_min(p.sum(-1), 1e-30)             # (b,kv,g,q)
        lse[..., s0:s1] = m[..., 0] + torch.log(l_sum)
        out[:, s0:s1] = (acc / l_sum.permute(0, 3, 1, 2)[..., None]).reshape(
            b, s1 - s0, h, d).to(qs.dtype)
    return out, lse.reshape(b, h, sq)


def flash_attention_bwd_ref(qs: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            window: int = 0, softcap: float = 0.0,
                            q_chunk: int = 512, kv_chunk: int = 512
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The plain version of ``flash_attention.flash_attention_bwd``: the
    JAX ``_flash_vjp_bwd`` (FlashAttention-2 recompute) block for block.

    An outer loop over ``kv_chunk`` key blocks accumulates each block's dk
    and dv over the live query blocks of the JAX ``_q_range``; dq adds up in
    an f32 (B, Sq, H, D) buffer.  p is recomputed per (q, kv) block as
    ``exp(logit - lse)`` (the JAX ``exp(logit - m) / l``), so no (Sq, Sk)
    array is ever made.  f32 inside, results in the inputs' dtype.
    """
    check_bwd_shapes(qs, k, v, o, do, lse, window=window, softcap=softcap)
    b, sq, h, d = qs.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    dev = qs.device
    qf = qs.reshape(b, sq, kv, g, d).float()
    dof = do.reshape(b, sq, kv, g, d).float()
    kf, vf = k.float(), v.float()
    lse_r = lse.reshape(b, kv, g, sq)
    delta = torch.einsum("bqkgd,bqkgd->bkgq", dof,
                         o.reshape(b, sq, kv, g, d).float())
    dq = torch.zeros((b, sq, kv, g, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, sk, kv, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    nq = -(-sq // q_chunk)
    for k0 in range(0, sk, kv_chunk):
        k1 = min(k0 + kv_chunk, sk)
        k_pos = torch.arange(k0, k1, device=dev)
        kb, vb = kf[:, k0:k1], vf[:, k0:k1]
        lo = k0 // q_chunk
        hi = (min((k0 + kv_chunk + window - 2) // q_chunk + 1, nq)
              if window > 0 else nq)
        for qi in range(lo, hi):
            q0, q1 = qi * q_chunk, min((qi + 1) * q_chunk, sq)
            qb, dob = qf[:, q0:q1], dof[:, q0:q1]
            q_pos = torch.arange(q0, q1, device=dev)
            raw = torch.einsum("bqkgd,bckd->bkgqc", qb, kb)
            logits = (torch.tanh(raw / softcap) * softcap if softcap > 0
                      else raw)
            logits = torch.where(_live_mask(q_pos, k_pos, sk, window),
                                 logits, MASKED)
            p = torch.exp(logits - lse_r[..., q0:q1, None])
            dp = torch.einsum("bqkgd,bckd->bkgqc", dob, vb)
            dlog = p * (dp - delta[..., q0:q1, None])
            if softcap > 0:
                dlog = dlog * (1.0 - torch.square(torch.tanh(raw / softcap)))
            dq[:, q0:q1] += torch.einsum("bkgqc,bckd->bqkgd", dlog, kb)
            dk[:, k0:k1] += torch.einsum("bkgqc,bqkgd->bckd", dlog, qb)
            dv[:, k0:k1] += torch.einsum("bkgqc,bqkgd->bckd", p, dob)
    return (dq.reshape(b, sq, h, d).to(qs.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
