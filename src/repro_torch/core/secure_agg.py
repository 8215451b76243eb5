"""Secure aggregation simulation (PyTorch counterpart of
``repro/core/secure_agg.py``; Bonawitz et al. 2016, cited in §2/App. A).

Pairwise additive masking: every client pair (i, j) derives a shared mask
from a common seed; client i ADDS the pair mask when i < j and SUBTRACTS
it when i > j, so the masks cancel in the server's sum — the server learns
only Σᵢ wᵢ·θᵢ, never an individual θᵢ. A pair's mask is drawn from a
``torch.Generator`` seeded by a hash of (the round's seed, lo, hi), so both
clients of the unordered pair derive the same mask. Dropout recovery and
key agreement are out of scope for the simulation.
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch.train.optim import tree_leaves, tree_map


def round_seed(gen: torch.Generator) -> int:
    """The round's seed, drawn from a copy of ``gen``: the caller's stream
    does not advance, so a masked fit draws exactly what an unmasked one
    draws."""
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return int(torch.randint(0, 2 ** 62, (1,), generator=g,
                             device=gen.device))


def pair_generator(seed: int, i: int, j: int,
                   device: torch.device) -> torch.Generator:
    """The generator both clients of the unordered pair {i, j} derive."""
    lo, hi = (i, j) if i < j else (j, i)
    h = hashlib.blake2b(f"{seed}:{lo}:{hi}".encode(), digest_size=8)
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h.digest(), "little") >> 1)


def mask_like(gen: torch.Generator, tree, scale: float):
    """scale · N(0, 1) f32 noise shaped like each leaf, leaf by leaf."""
    return tree_map(lambda l: scale * torch.randn(
        l.shape, generator=gen, device=l.device, dtype=torch.float32), tree)


def mask_update(seed: int, client_id: int, n_clients: int, update,
                weight: float, *, scale: float = 10.0):
    """Client-side: weight the update and add the pairwise masks.
    Returns the masked contribution wᵢ·θᵢ + Σⱼ ±mask_{ij}."""
    out = tree_map(lambda a: weight * a.float(), update)
    dev = tree_leaves(update)[0].device
    for j in range(n_clients):
        if j == client_id:
            continue
        m = mask_like(pair_generator(seed, client_id, j, dev), update, scale)
        sign = 1.0 if client_id < j else -1.0
        out = tree_map(lambda a, mm: a + sign * mm, out, m)
    return out


def secure_aggregate(masked_contributions, total_weight: float):
    """Server-side: sum the masked contributions (masks cancel) and
    normalize. The server never handles an unmasked individual update."""
    total = masked_contributions[0]
    for c in masked_contributions[1:]:
        total = tree_map(torch.add, total, c)
    return tree_map(lambda a: a / max(total_weight, 1e-12), total)

