"""Place recognition (counterpart of `qsp_slam_tpu/slam/place_recognition.py`):
the matcher vocabulary's word ids, the multi-table LSH signature every
keyframe appends to a uint8 database, and the idf-weighted cosine queries
that relocalization (and, in a later slice, loop closing) run against it.
Top-k selection is a stable descending sort, which breaks ties by the
lower index as `jax.lax.top_k` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..frontend.fast import topk_stable
from ..frontend.orb import DESC_BITS

NUM_WORDS = 512


def _make_vocab(seed: int = 11, words: int = NUM_WORDS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice([-1, 1], size=(words, DESC_BITS)).astype(np.int8)


# The matcher vocabulary (`quantize_words`, bag-of-words matching), kept
# bit-identical to the reference.
_VOCAB = _make_vocab()


def quantize_words(desc_pm: torch.Tensor) -> torch.Tensor:
    """(F, 256) ±1 descriptors -> (F,) int32 vocabulary word ids: argmax of
    the ±1 products with the 512 words, first index on ties.  The products
    are integers of magnitude <= 256, so an f32 matmul holds them exactly."""
    vocab = torch.from_numpy(_VOCAB).to(desc_pm.device).to(torch.float32)
    sim = desc_pm.to(torch.float32) @ vocab.T
    return torch.argmax(sim, dim=-1).to(torch.int32)

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


def _idf_scores(db: PlaceDatabase, sig: torch.Tensor) -> torch.Tensor:
    """idf-weighted cosine of `sig` against every stored signature: bins
    present in most keyframes carry little evidence (weight log(N/df));
    the weighted vectors are re-normalised, so scores stay in [0, 1]."""
    n = torch.clamp(db.count.to(torch.float32), min=1.0)
    idf = torch.log((1.0 + n) / (1.0 + db.df))
    q = sig * idf
    q = q / torch.clamp(torch.linalg.vector_norm(q), min=1e-9)
    S = db.signatures.to(torch.float32)
    num = S @ (idf * q)
    norm2 = (S * S) @ (idf * idf)
    return num / torch.sqrt(torch.clamp(norm2, min=1e-18))


def _eligible(db: PlaceDatabase, exclude_recent: int) -> torch.Tensor:
    kf_ids = torch.arange(db.signatures.shape[0], device=db.count.device)
    return kf_ids < db.count - exclude_recent


def query(db: PlaceDatabase, sig: torch.Tensor, exclude_recent: int = 10):
    """(best keyframe id, its score) among all but the `exclude_recent`
    newest keyframes; callers threshold the score."""
    scores = torch.where(_eligible(db, exclude_recent), _idf_scores(db, sig), -1.0)
    best = torch.argmax(scores)
    return best.to(torch.int32), scores[best]


def _topk(db: PlaceDatabase, scores: torch.Tensor, k: int, exclude_recent: int):
    scores = torch.where(_eligible(db, exclude_recent), scores, -torch.inf)
    top_scores, top_ids = topk_stable(scores, k)
    good = torch.isfinite(top_scores)
    return torch.where(good, top_ids.to(torch.int32), -1), torch.where(good, top_scores, -1.0)


def query_topk(db: PlaceDatabase, sig: torch.Tensor, k: int = 4, exclude_recent: int = 10):
    """Top-k candidates: ids (k,) int32 and scores (k,), id -1 and score -1
    where fewer keyframes are eligible."""
    return _topk(db, _idf_scores(db, sig), k, exclude_recent)


def query_topk_with_ref(
    db: PlaceDatabase, sig: torch.Tensor, k: int = 4, exclude_recent: int = 10, ref_window: int = 8
):
    """`query_topk` plus the adaptive floor: the lowest score among the
    `ref_window` keyframes before the newest (the newest is the querying
    keyframe itself), 0 when there are none."""
    scores = _idf_scores(db, sig)
    kf_ids = torch.arange(db.signatures.shape[0], device=db.count.device)
    ref_ok = (kf_ids >= db.count - 1 - ref_window) & (kf_ids < db.count - 1)
    ref_min = torch.min(torch.where(ref_ok, scores, torch.inf))
    return (*_topk(db, scores, k, exclude_recent), torch.where(torch.isfinite(ref_min), ref_min, 0.0))
