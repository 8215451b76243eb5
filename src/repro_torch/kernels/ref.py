"""Plain PyTorch oracles: the port's copies of the reference package's
``kernels/ref.py`` for the ported kernels. They are the ground truth the
port is held against in tests (each is checked against its JAX twin on the
same inputs), and ``paged_gather_ref`` is the CPU model path's page gather.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def kmeans_assign_ref(x, cents):
    """x: (n, d), cents: (K, d) → (n,) int32 nearest-centroid index.

    Distance via the expansion ‖x−μ‖² = ‖x‖² − 2xμᵀ + ‖μ‖²; the ‖x‖² term is
    constant per row and dropped (argmin-invariant). Ties take the first
    index."""
    xc = x.float() @ cents.float().T                              # (n, K)
    c2 = torch.sum(cents.float() ** 2, dim=-1)                    # (K,)
    return torch.argmin(c2[None, :] - 2.0 * xc, dim=-1).to(torch.int32)


def kmeans_assign_reduce_ref(x, cents, w):
    """x: (n, d), cents: (K, d), w: (n,) →
    (assign (n,) int32, sums (K, d) f32, counts (K,) f32): the
    nearest-centroid argmin plus the weighted one-hot reduction a Lloyd's
    step needs (sums[k] = Σ_{assign_i=k} w_i·x_i, counts[k] = Σ w_i),
    accumulated in f32."""
    K = cents.shape[0]
    assign = kmeans_assign_ref(x, cents)
    wv = F.one_hot(assign.long(), K).float() * w.float()[:, None]  # (n, K)
    return assign, wv.T @ x.float(), wv.sum(dim=0)


def router_utility_ref(h, acc_w, acc_b, cost_w, cost_b, lam):
    """Fused routing decision on trunk features.

    h: (n, dh) trunk hidden; heads (dh, M)/(M,).
    Returns (choice (n,) int32, best utility (n,) f32)."""
    hf = h.float()
    A = torch.sigmoid(hf @ acc_w.float() + acc_b.float())
    C = hf @ cost_w.float() + cost_b.float()
    U = A - lam * C
    return torch.argmax(U, dim=-1).to(torch.int32), U.amax(dim=-1)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q, k, v: (B, S, H, hd) (same head count — the caller repeats GQA
    heads). Scores in f32 from upcast q and k, scaled by hd^-0.5; the causal
    form masks later keys with -1e30; softmax and p·v in f32. Returns
    (B, S, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if causal:
        m = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
        scores = torch.where(m, scores, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _n_valid_col(n_valid, B: int, device) -> torch.Tensor:
    nv = torch.as_tensor(n_valid, dtype=torch.int32, device=device)
    return nv.reshape(-1).expand(B).reshape(B, 1, 1, 1)


def decode_attention_ref(q, k_cache, v_cache, n_valid):
    """q: (B,Hkv,g,hd); caches (B,Hkv,S,hd) head-major; n_valid scalar or
    (B,) per-row validity bound. A row with bound 0 returns exactly 0.
    Returns (B,Hkv,g,hd) in q's dtype."""
    B, S = k_cache.shape[0], k_cache.shape[2]
    hd = q.shape[-1]
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k_cache.float()) * hd ** -0.5
    nv = _n_valid_col(n_valid, B, q.device)
    valid = torch.arange(S, device=q.device).reshape(1, 1, 1, S) < nv
    s = torch.where(valid, s, torch.tensor(-1e30, dtype=torch.float32,
                                           device=q.device))
    # explicit masked softmax: a fully-invalid row accumulates l = 0 and
    # emits 0 instead of a uniform average over garbage
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros((), device=q.device))
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.to(q.dtype)


def paged_gather_ref(pool, page_table):
    """pool: (P, Hkv, ps, hd) page-major; page_table: (B, npg) int32.
    Materializes each row's contiguous logical view (B, Hkv, npg*ps, hd)
    by gathering its pages out of the shared pool."""
    B, npg = page_table.shape
    _, Hkv, ps, hd = pool.shape
    g = pool[page_table.long()]                # (B, npg, Hkv, ps, hd)
    g = g.movedim(2, 1)                        # (B, Hkv, npg, ps, hd)
    return g.reshape(B, Hkv, npg * ps, hd)


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, n_valid):
    """q: (B,Hkv,g,hd); pools (P,Hkv,ps,hd) shared by all rows; page_table
    (B,npg) int32; n_valid (B,) per-row bound. Gathers each row's pages
    and runs the contiguous oracle — positions past n_valid (including
    trash-page table entries) are masked. Returns (B,Hkv,g,hd)."""
    return decode_attention_ref(q, paged_gather_ref(k_pool, page_table),
                                paged_gather_ref(v_pool, page_table),
                                n_valid)


def paged_decode_attention_seg_ref(q, k_pool, v_pool, page_table, n_valid):
    """Segment-summed paged decode: the same contract as
    ``paged_decode_attention_ref`` without the per-row K/V copy. q scores
    against every pool page, and a page-membership count
    (count[b,p,k] = how many valid logical slots of row b live at pool
    slot (p,k)) masks and weights the exp terms; duplicate table entries
    count with multiplicity, as in the gathered view. Agrees with the
    gather oracle to f32 reduction-order noise, not bitwise."""
    P, Hkv, ps, hd = k_pool.shape
    B, npg = page_table.shape
    dev = q.device
    s = torch.einsum("bhgd,phkd->bhgpk", q.float(), k_pool.float()) * hd ** -0.5
    member = torch.nn.functional.one_hot(page_table.long(), P).float()
    nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev).reshape(-1)
    pos = (torch.arange(npg, device=dev)[:, None] * ps
           + torch.arange(ps, device=dev)[None, :])
    valid = (pos[None] < nv[:, None, None]).float()           # (B,npg,ps)
    count = torch.einsum("bip,bik->bpk", member, valid)       # (B, P, ps)
    cnt = count[:, None, None]                                # (B,1,1,P,ps)
    s = torch.where(cnt > 0, s, torch.tensor(-1e30, device=dev))
    m = s.amax(dim=(-2, -1), keepdim=True)
    p = cnt * torch.exp(s - m)
    p = p / torch.clamp(p.sum(dim=(-2, -1), keepdim=True), min=1e-30)
    out = torch.einsum("bhgpk,phkd->bhgd", p, v_pool.float())
    return out.to(q.dtype)
