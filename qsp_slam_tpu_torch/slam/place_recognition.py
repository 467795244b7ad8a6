"""Place-recognition signatures and their store (counterpart of
`qsp_slam_tpu/slam/place_recognition.py`, the parts every keyframe runs:
the multi-table LSH signature and the uint8 database it is appended to).
Querying arrives with the recovery and loop-closing slices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..frontend.orb import DESC_BITS

NUM_WORDS = 512


def _make_vocab(seed: int = 11, words: int = NUM_WORDS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice([-1, 1], size=(words, DESC_BITS)).astype(np.int8)


# The matcher vocabulary (`quantize_words`, bag-of-words matching), kept
# bit-identical to the reference for the slices that use it.
_VOCAB = _make_vocab()

# Multi-table LSH signature: T tables x B sampled bits -> (T * 2^B,) histogram.
LSH_TABLES = 64
LSH_BITS = 10
SIG_DIM = LSH_TABLES << LSH_BITS


def _make_lsh_subsets(seed: int = 7, tables: int = LSH_TABLES, bits: int = LSH_BITS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.choice(DESC_BITS, size=bits, replace=False) for _ in range(tables)]
    ).astype(np.int32)  # (T, B)


_LSH_SUBSETS = _make_lsh_subsets()


def bow_signature(desc_pm: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(F, 256) ±1 descriptors -> L2-normalized LSH histogram (SIG_DIM,):
    per table, the B sampled bits packed to a word in [0, 2^B)."""
    dev = desc_pm.device
    idx = torch.from_numpy(_LSH_SUBSETS).to(dev).long()  # (T, B)
    bits = (desc_pm[:, idx] > 0).to(torch.int64)  # (F, T, B)
    pw = torch.from_numpy(1 << np.arange(LSH_BITS)).to(dev)
    words = torch.sum(bits * pw, dim=-1)  # (F, T)
    offs = (torch.arange(LSH_TABLES, device=dev) << LSH_BITS)[None, :]
    flat = torch.where(valid[:, None], words + offs, SIG_DIM)  # invalid -> spill bin
    hist = torch.bincount(flat.reshape(-1), minlength=SIG_DIM + 1)[:SIG_DIM].to(torch.float32)
    n = torch.linalg.vector_norm(hist)
    return hist / torch.where(n == 0, 1.0, n)


class PlaceDatabase(NamedTuple):
    """One uint8 (per-row max-quantized) signature per keyframe, plus the
    document frequency of every bin."""

    signatures: torch.Tensor  # (Kmax, SIG_DIM) uint8
    df: torch.Tensor  # (SIG_DIM,) f32 — keyframes containing each bin
    count: torch.Tensor  # () int32


def empty_database(kmax: int = 64, device=None) -> PlaceDatabase:
    dev = resolve_device(device)
    return PlaceDatabase(
        signatures=torch.zeros((kmax, SIG_DIM), dtype=torch.uint8, device=dev),
        df=torch.zeros(SIG_DIM, dtype=torch.float32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def quantize_signature(sig: torch.Tensor) -> torch.Tensor:
    """L2-normalized f32 signature -> uint8 row scaled to its maximum."""
    m = torch.max(sig)
    return torch.round(sig / torch.where(m > 0, m, 1.0) * 255.0).to(torch.uint8)


def add_signature(db: PlaceDatabase, sig: torch.Tensor) -> PlaceDatabase:
    """Append a signature; at capacity the write is dropped."""
    kmax = db.signatures.shape[0]
    fits = db.count < kmax
    slot = torch.clamp(db.count, 0, kmax - 1).long().reshape(1)
    q = quantize_signature(sig)
    signatures = db.signatures.clone()
    signatures[slot] = torch.where(fits, q, db.signatures[slot])
    return PlaceDatabase(
        signatures=signatures,
        df=db.df + torch.where(fits, (q > 0).to(torch.float32), 0.0),
        count=db.count + fits.to(torch.int32),
    )
