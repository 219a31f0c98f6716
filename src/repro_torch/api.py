"""``repro_torch.api`` — the sketch engines of ``repro.api`` on PyTorch/CUDA.

    engine = repro_torch.api.get_engine("gbkmv")      # or "gkmv", "kmv"
    index  = engine.build(records, budget)            # device="cuda"
    hits   = index.batch_query(queries, 0.5)          # one id array per query
    top    = index.topk(q_ids, k=10)                  # (ids, scores)
    index.save(path); repro_torch.api.load_index(path)

Engines: ``gbkmv`` (G-KMV tail plus a top-r bitmap buffer), ``gkmv`` (the
tail alone: buffer width 0) and ``kmv`` (every record's k smallest hashes,
k = max(budget // m, 2)). Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``; with no card a default call
raises. ``backend="torch"`` scores with the hand kernels on CUDA (their
plain versions on CPU tensors), ``"numpy"`` with the host estimator.
``build_backend="torch"`` runs the fused device build (the B2 kernel),
``"numpy"`` the host build.

``query``/``batch_query``/``topk`` take ``plan`` ∈ {"auto", "dense",
"pruned"} as the reference does: "auto" asks the planner to pick the
cheaper route per batch from the postings' selectivity, the others force
one. Every route returns the same answers.

- The dense route scores every record (kernel B1; kmv's pair estimator
  as torch ops on the index's device).
- The pruned route of gbkmv and gkmv with ``backend="torch"`` is the
  device pipeline (``planner/device.py``): postings probe (kernel B3),
  block decode and K∩ scatter (kernel B4), the closed-form estimator, and
  packed hit words or a top-k, with one staged upload and one fetch per
  batch.
- Otherwise the pruned route is the reference's host filter-and-verify:
  candidates from the block postings on the host, scored in one call
  (kernel B5 or its host twin; kmv's estimator query by query).

Postings are built on the first planned query, or at build time with
``postings="eager"``; after a device build (``build_backend="torch"``)
the eager tail postings are encoded where the columns live. ``explain=``,
``insert`` and ``windowed=True`` raise ``NotImplementedError`` until their
slices land.

Index files use the reference's npz keys, so a file saved by either
package loads in the other, postings included: a save writes the blocked
``post_*`` keys when the postings exist, and a load reads them (version 3
blocked stores, or version 2 flat CSR re-encoded into blocks).
"""

from __future__ import annotations

import zipfile

import numpy as np
import torch

from repro_torch import planner
from repro_torch.core import gbkmv as gbkmv_mod
from repro_torch.core import gkmv as gkmv_mod
from repro_torch.core import kmv as kmv_mod
from repro_torch.core.arena import SketchArena
from repro_torch.core.estimators import (containment_matrix,
                                         kmv_pair_estimate, normalize_backend)
from repro_torch.core.hashing import (PAD, as_u64, hash_u32_np, to_numpy,
                                      to_tensor)
from repro_torch.core.sketches import PackedSketches
from repro_torch.device import resolve_device
from repro_torch.kernels.gather_score import PairScorer
from repro_torch.planner import (BlockStore, PostingsIndex, QueryPlan,
                                 from_flat, threshold_hits_packed, topk_select)
from repro_torch.planner import device as planner_device
from repro_torch.planner.postings import build_postings_device

# ---------------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------------

_ENGINES: dict[str, type] = {}


def register_engine(name: str):
    """Class decorator: make an engine reachable as ``get_engine(name)``."""

    def deco(cls):
        cls.name = name
        _ENGINES[name] = cls
        return cls

    return deco


def get_engine(name: str):
    """Engine class for ``name`` (``.build(records, budget, **cfg)``)."""
    try:
        return _ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered: {sorted(_ENGINES)}"
        ) from None


def list_engines() -> list[str]:
    return sorted(_ENGINES)


def build(name: str, records, budget: int | None = None, **cfg):
    """Convenience: ``get_engine(name).build(records, budget, **cfg)``."""
    return get_engine(name).build(records, budget, **cfg)


def _not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; it arrives with ROADMAP.md Queue A "
        f"{slice_}")


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


class CorruptIndexError(ValueError):
    """A saved index file exists but cannot be decoded (truncated
    download, torn write, wrong file). A missing file still raises
    ``FileNotFoundError``."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt or invalid index file {path!r}: {reason}")
        self.path = path
        self.reason = reason


def load_index(path: str, device="cuda"):
    """Load an index saved by ``save`` in either package (dispatches on the
    stored engine name); its scoring runs on ``device``."""
    device = resolve_device(device)
    try:
        with np.load(path, allow_pickle=False) as data:
            d = {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, ValueError, KeyError, OSError, EOFError) as e:
        raise CorruptIndexError(path, f"{type(e).__name__}: {e}") from e
    if "engine" not in d:
        raise CorruptIndexError(path, "not an index file (no 'engine' key)")
    engine = str(d.pop("engine"))
    try:
        cls = get_engine(engine)
    except ValueError as e:
        raise CorruptIndexError(path, str(e)) from e
    try:
        return cls._load(d, device)
    except (KeyError, ValueError, IndexError) as e:
        raise CorruptIndexError(
            path, f"payload missing or malformed ({type(e).__name__}: "
                  f"{e})") from e


_ARENA_VERSION = 3

# Backend names as files store them: the reference knows "jnp" (its XLA
# route) and "pallas" (its kernels); both mean this port's "torch".
_BACKEND_TO_FILE = {"torch": "jnp", "numpy": "numpy"}
_BACKEND_FROM_FILE = {"jnp": "torch", "pallas": "torch", "numpy": "numpy"}


# Per-store npz key suffixes of the blocked postings (version 3).
_STORE_FIELDS = ("row_blocks", "first", "last", "meta", "off", "payload")


def _arena_to_npz(s: SketchArena) -> dict:
    """The packed columns under the reference's npz keys (u32 columns as
    uint32), plus the blocked postings when they have been built."""
    d = {
        "values": to_numpy(s.values),
        "lengths": s.lengths.cpu().numpy(),
        "thresh": to_numpy(s.thresh),
        "buf": to_numpy(s.buf),
        "sizes": s.sizes.cpu().numpy(),
        "arena_version": np.int64(_ARENA_VERSION),
    }
    post = s._post
    if post is not None:
        d["post_keys"] = post.keys
        d["post_tau"] = np.uint32(post.tau)
        for prefix, store in (("post_blk_", post.tail),
                              ("post_buf_blk_", post.buf)):
            for f in _STORE_FIELDS:
                d[prefix + f] = getattr(store, f)
    return d


def _arena_from_npz(d: dict) -> SketchArena:
    """An arena (CPU tensors) from any reference file version:

    v3  ``post_blk_*`` / ``post_buf_blk_*`` blocked stores, installed as
        they are
    v2  flat-CSR ``post_offsets``/``post_rec_ids``/..., encoded into
        blocks on load
    v1  no ``post_*`` keys: postings stay lazy
    """
    arena = SketchArena.from_pack(PackedSketches.from_numpy(
        values=np.asarray(d["values"], np.uint32),
        lengths=d["lengths"], thresh=np.asarray(d["thresh"], np.uint32),
        buf=np.asarray(d["buf"], np.uint32), sizes=d["sizes"]))
    if "post_blk_row_blocks" in d:
        tail, buf = (BlockStore(**{f: d[prefix + f] for f in _STORE_FIELDS})
                     for prefix in ("post_blk_", "post_buf_blk_"))
        arena.install_postings(PostingsIndex(
            keys=d["post_keys"], tail=tail, buf=buf,
            num_records=arena.num_records, tau=np.uint32(d["post_tau"])))
    elif "post_keys" in d:
        arena.install_postings(from_flat(
            d["post_keys"], d["post_offsets"], d["post_rec_ids"],
            d["post_buf_offsets"], d["post_buf_rec_ids"],
            arena.num_records, np.uint32(d["post_tau"])))
    return arena


def _validate_postings_arg(postings: str) -> None:
    """Reject a bad ``postings=`` before the build runs."""
    if postings not in ("lazy", "eager"):
        raise ValueError(f"postings must be 'lazy' or 'eager', "
                         f"got {postings!r}")


def index_from_arrays(d: dict, device="cuda") -> "GBKMVApiIndex":
    """A port index from the numpy dict of a GB-KMV index: the column keys
    of ``_arena_to_npz`` plus ``tau``, ``top_elems``, ``seed``,
    ``buffer_bits`` and optionally ``budget`` and ``backend`` — what a
    saved file of either package holds."""
    return GBKMVEngine._load(dict(d), resolve_device(device))


def index_to_arrays(index: "GBKMVApiIndex") -> dict:
    """The numpy dict ``save`` writes (without the engine name)."""
    core = index.core
    return {
        "tau": np.uint32(core.tau),
        "top_elems": np.asarray(core.top_elems, np.int64),
        "seed": np.int64(core.seed),
        "buffer_bits": np.int64(core.buffer_bits),
        "budget": np.int64(index.budget if index.budget is not None else -1),
        "backend": _BACKEND_TO_FILE[index.backend],
        **_arena_to_npz(core.sketches),
    }


# ---------------------------------------------------------------------------
# The planned query protocol shared by the sketch engines
# ---------------------------------------------------------------------------


def _eager_postings(arena: SketchArena, device_built: bool) -> None:
    """Encode the block postings before the first query. After a device
    build the tail is encoded where the columns live and its mirror
    adopted as it is; the columns are pinned to the host once and stay
    resident on the device."""
    if device_built:
        post, dpost = build_postings_device(arena)
        arena.ensure_host()
        arena.install_postings(post)
        arena.adopt_device_postings(dpost)
    else:
        arena.postings()


def _backend_from_file(d: dict) -> str:
    stored = str(d.get("backend", "jnp"))
    return _BACKEND_FROM_FILE.get(stored, stored)


def _not_windowed(windowed: bool) -> None:
    if windowed:
        raise _not_ported("windowed=True (the time-windowed index)",
                          "slice 5c")


class _PlannedIndexMixin:
    """The reference's planned query protocol over a sketch arena.

    ``query``/``batch_query``/``topk`` take ``plan`` ∈ {"auto", "dense",
    "pruned"}. The postings live on the arena, built on the first planned
    query. The pruned route runs the device pipeline when the engine's
    scores have a device twin (``_device_prunable``) and ``backend`` is
    "torch"; otherwise the host filter-and-verify, scored by
    ``_pair_score_fn``.

    Engines provide ``_sketch_pack`` (the arena). Engines scored from
    packed columns (gbkmv, gkmv) provide ``_query_pack`` and take the
    defaults below: dense scores by ``containment_matrix`` (B1), verify by
    :class:`PairScorer` (B5). Others override ``_plan_queries``,
    ``_score_matrix`` and ``_pair_score_fn``.
    """

    engine = "?"
    last_plan: QueryPlan | None = None     # the latest planned batch's route
    # Per query, on the host pruned route; None on the device route, which
    # makes no candidate sets.
    last_candidate_sizes: list | None = None
    _device_prunable = False               # scores have a device twin
    backend: str
    device: torch.device

    # -- hooks ------------------------------------------------------------------

    def _sketch_pack(self) -> SketchArena:
        raise NotImplementedError

    def _query_pack(self, queries) -> PackedSketches:
        raise NotImplementedError

    def _plan_queries(self, queries):
        """(query pack, retained-hash rows, buffer-bit rows, sizes)."""
        qp = self._query_pack(queries)
        return (qp,) + planner.unpack_query_rows(qp)

    def _scoring_pack(self) -> PackedSketches:
        """The columns the backend scores: resident on the index's device
        for ``"torch"``, the arena itself for ``"numpy"``."""
        x = self._sketch_pack()
        return x.device_pack(self.device) if self.backend == "torch" else x

    def _score_matrix(self, queries, *, as_numpy: bool, qp=None):
        """f32[m, Gq] for a query batch: a tensor on the index's device
        for the torch backend (unless ``as_numpy``), numpy otherwise."""
        if qp is None:
            qp = self._query_pack(queries)
        return containment_matrix(qp, self._scoring_pack(),
                                  backend=self.backend, as_numpy=as_numpy)

    def _pair_score_fn(self, qp):
        """The ragged verify scorer over this index and query pack (placed
        once, not per scored chunk)."""
        return PairScorer(self._scoring_pack(), qp, backend=self.backend)

    def _postings(self) -> PostingsIndex:
        return self._sketch_pack().postings()

    def _dense_batch_query(self, queries, threshold, qp=None):
        """The comparison runs where the scores are; only the mask is
        fetched."""
        s = self._score_matrix(queries, as_numpy=False, qp=qp)
        return threshold_hits_packed(s, threshold)

    def _dense_topk(self, q_ids, k: int, qp=None):
        s = self._score_matrix([q_ids], as_numpy=True, qp=qp)[:, 0]
        return topk_select(np.arange(len(s), dtype=np.int64), s, k, len(s))

    # -- queries ------------------------------------------------------------

    @property
    def num_records(self) -> int:
        return self._sketch_pack().num_records

    def scores(self, q_ids) -> np.ndarray:
        """Estimated containment Ĉ(Q→X) for every record (f32[m])."""
        return self._score_matrix([np.asarray(q_ids)], as_numpy=True)[:, 0]

    def batch_scores(self, queries) -> np.ndarray:
        """f32[m, Gq] — one index sweep for a whole query batch."""
        return self._score_matrix([np.asarray(q) for q in queries],
                                  as_numpy=True)

    def query(self, q_ids, threshold: float, *, plan: str = "auto",
              explain: bool = False):
        return self.batch_query([q_ids], threshold, plan=plan,
                                explain=explain)[0]

    def batch_query(self, queries, threshold: float, *, plan: str = "auto",
                    explain: bool = False) -> list[np.ndarray]:
        """Record ids with Ĉ ≥ threshold, one sorted array per query, by
        the route ``plan`` names or the planner picks."""
        if explain:
            raise _not_ported("explain=True (per-query explain dicts)",
                              "slice 7")
        plan = planner.normalize_plan(plan)
        queries = [np.asarray(q) for q in queries]
        if not queries:
            return []
        if plan == "dense" or float(threshold) <= 0.0:
            self.last_plan = QueryPlan(
                "dense", np.nan, np.nan, 0,
                "forced" if plan == "dense" else "threshold <= 0")
            return self._dense_batch_query(queries, threshold)
        qp, hash_rows, bit_rows, sizes = self._plan_queries(queries)
        s = self._sketch_pack()
        decision = planner.choose_plan(
            self._postings(), hash_rows, bit_rows, threshold,
            s.num_records, s.capacity, plan=plan)
        self.last_plan = decision
        if decision.path == "dense":
            return self._dense_batch_query(queries, threshold, qp=qp)
        if self._device_prunable and self.backend == "torch":
            self.last_candidate_sizes = None
            return planner_device.pruned_batch_device(
                s, qp, threshold, device=self.device, plan=decision)
        ids, cands = planner.pruned_batch(
            self._postings(), hash_rows, bit_rows, sizes, threshold,
            self._pair_score_fn(qp))
        self.last_candidate_sizes = [len(c.rec_ids) for c in cands]
        return ids

    def topk(self, q_ids, k: int, *,
             plan: str = "auto") -> tuple[np.ndarray, np.ndarray]:
        """(record ids, scores) of the k highest estimated containments:
        score descending, ties by ascending record id. The pruned route
        ranks exactly as the dense sweep: on the device it takes the top k
        of the pipeline's score matrix; on the host it scores candidates
        in bound order with the running k-th score as the moving
        threshold."""
        plan = planner.normalize_plan(plan)
        s = self._sketch_pack()
        if plan == "dense" or int(k) <= 0 or s.num_records == 0:
            return self._dense_topk(q_ids, k)
        qp, hash_rows, bit_rows, sizes = self._plan_queries(
            [np.asarray(q_ids)])
        if plan == "auto":
            decision = planner.choose_plan(
                self._postings(), hash_rows, bit_rows, 1.0,
                s.num_records, s.capacity)
            self.last_plan = decision
            if decision.path == "dense":
                return self._dense_topk(q_ids, k, qp=qp)
        else:
            self.last_plan = QueryPlan("pruned", np.nan, np.nan, 0,
                                       "forced topk")
        if self._device_prunable and self.backend == "torch":
            return planner_device.pruned_topk_device(
                s, qp, k, device=self.device)[0]
        return planner.pruned_topk(
            self._postings(), hash_rows[0], bit_rows[0], int(sizes[0]), k,
            self._pair_score_fn(qp), s.num_records)

    def insert(self, new_records, budget: int | None = None):
        raise _not_ported("insert (dynamic maintenance)", "slice 5b")

    def nbytes(self) -> int:
        return self._sketch_pack().nbytes()


# ---------------------------------------------------------------------------
# GB-KMV
# ---------------------------------------------------------------------------


@register_engine("gbkmv")
class GBKMVEngine:
    """GB-KMV: G-KMV tail + top-r frequent-element bitmap buffer."""

    @classmethod
    def build(cls, records, budget, r="auto", seed=0, capacity=None,
              backend="torch", tau_mode="exact", build_backend="torch",
              postings="lazy", windowed=False, device="cuda"):
        """Vectorized construction. ``backend`` picks the scoring
        implementation, ``build_backend`` the construction path;
        ``tau_mode`` ∈ {"exact", "histogram"}; ``postings="eager"``
        encodes the block postings before returning, so the first pruned
        query pays no inversion."""
        _not_windowed(windowed)
        _validate_postings_arg(postings)
        device = resolve_device(device)
        core = gbkmv_mod.build_gbkmv(
            records, budget=budget, r=r, seed=seed, capacity=capacity,
            tau_mode=tau_mode, build_backend=build_backend, device=device)
        idx = GBKMVApiIndex(core, budget=int(budget), backend=backend,
                            device=device)
        if postings == "eager":
            _eager_postings(idx.core.sketches, build_backend == "torch")
        return idx

    @classmethod
    def _load(cls, d: dict, device) -> "GBKMVApiIndex":
        core = gbkmv_mod.GBKMVIndex(
            sketches=_arena_from_npz(d), tau=np.uint32(d["tau"]),
            top_elems=np.asarray(d["top_elems"], np.int64),
            seed=int(d["seed"]), buffer_bits=int(d["buffer_bits"]))
        budget = int(d["budget"]) if "budget" in d else -1
        return GBKMVApiIndex(core, budget=budget if budget >= 0 else None,
                             backend=_backend_from_file(d), device=device)


class GBKMVApiIndex(_PlannedIndexMixin):
    """A built GB-KMV index behind the planned query protocol."""

    engine = "gbkmv"
    _device_prunable = True

    def __init__(self, core: gbkmv_mod.GBKMVIndex, budget: int | None,
                 backend: str = "torch", device="cuda"):
        core.sketches = SketchArena.from_pack(core.sketches)
        self.core = core
        self.budget = budget
        self.backend = normalize_backend(backend)
        self.device = resolve_device(device)

    def _sketch_pack(self) -> SketchArena:
        return self.core.sketches

    def _query_pack(self, queries) -> PackedSketches:
        return gbkmv_mod.sketch_query_batch(self.core, queries)

    def save(self, path: str) -> None:
        np.savez_compressed(path, engine="gbkmv", **index_to_arrays(self))


# ---------------------------------------------------------------------------
# G-KMV (global threshold, no buffer) and plain KMV (Theorem 1 allocation)
# ---------------------------------------------------------------------------


def _gkmv_tau(sk: PackedSketches) -> int:
    """The index's τ as the reference reads it: the largest row threshold
    (PAD − 1 for an empty index)."""
    return int(as_u64(sk.thresh).max()) if sk.num_records else int(PAD) - 1


@register_engine("gkmv")
class GKMVEngine:
    """G-KMV: global hash threshold τ, no frequent-element buffer."""

    @classmethod
    def build(cls, records, budget, seed=0, capacity=None, backend="torch",
              tau_mode="exact", build_backend="torch", postings="lazy",
              windowed=False, device="cuda"):
        """A G-KMV index: the knobs of :meth:`GBKMVEngine.build` without
        the buffer."""
        _not_windowed(windowed)
        _validate_postings_arg(postings)
        device = resolve_device(device)
        sk = gkmv_mod.build_gkmv(records, budget=budget, seed=seed,
                                 capacity=capacity, tau_mode=tau_mode,
                                 build_backend=build_backend, device=device)
        if postings == "eager":
            _eager_postings(sk, build_backend == "torch")
        return GKMVApiIndex(sk, tau=_gkmv_tau(sk), seed=seed,
                            backend=backend, device=device)

    @staticmethod
    def wrap(sk: PackedSketches, seed: int = 0, backend: str = "torch",
             device="cuda") -> "GKMVApiIndex":
        return GKMVApiIndex(sk, tau=_gkmv_tau(sk), seed=seed,
                            backend=backend, device=device)

    @classmethod
    def _load(cls, d: dict, device) -> "GKMVApiIndex":
        return GKMVApiIndex(_arena_from_npz(d), tau=int(d["tau"]),
                            seed=int(d["seed"]),
                            backend=_backend_from_file(d), device=device)


class GKMVApiIndex(_PlannedIndexMixin):
    """A built G-KMV index: gbkmv's routes at buffer width 0, the device
    pipeline included."""

    engine = "gkmv"
    _device_prunable = True

    def __init__(self, sketches: PackedSketches, tau: int, seed: int,
                 backend: str = "torch", device="cuda"):
        self.sketches = SketchArena.from_pack(sketches)
        self.tau = np.uint32(tau)
        self.seed = int(seed)
        self.backend = normalize_backend(backend)
        self.device = resolve_device(device)

    def _sketch_pack(self) -> SketchArena:
        return self.sketches

    def _query_pack(self, queries) -> PackedSketches:
        return gkmv_mod.sketch_query_batch(queries, self.tau, seed=self.seed,
                                           capacity=self.sketches.capacity)

    def save(self, path: str) -> None:
        np.savez_compressed(path, engine="gkmv", tau=np.uint32(self.tau),
                            seed=np.int64(self.seed),
                            backend=_BACKEND_TO_FILE[self.backend],
                            **_arena_to_npz(self.sketches))


@register_engine("kmv")
class KMVEngine:
    """Plain KMV, uniform k = floor(budget/m) per record (Theorem 1)."""

    @classmethod
    def build(cls, records, budget, seed=0, backend="torch",
              build_backend="torch", postings="lazy", windowed=False,
              device="cuda"):
        """A plain-KMV index (every record's k smallest hashes)."""
        _not_windowed(windowed)
        _validate_postings_arg(postings)
        device = resolve_device(device)
        sk = kmv_mod.build_kmv(records, budget=budget, seed=seed,
                               build_backend=build_backend, device=device)
        if postings == "eager":
            _eager_postings(sk, build_backend == "torch")
        return KMVApiIndex(sk, seed=seed, backend=backend, device=device)

    @staticmethod
    def wrap(sk: PackedSketches, seed: int = 0, backend: str = "torch",
             device="cuda") -> "KMVApiIndex":
        return KMVApiIndex(sk, seed=seed, backend=backend, device=device)

    @classmethod
    def _load(cls, d: dict, device) -> "KMVApiIndex":
        return KMVApiIndex(_arena_from_npz(d), seed=int(d["seed"]),
                           backend=_backend_from_file(d), device=device)


class KMVApiIndex(_PlannedIndexMixin):
    """A built plain-KMV index. Its pair estimator (k = min(k_Q, k_X),
    Eq. 8-10) is not B1's, so it scores with
    :func:`repro_torch.core.estimators.kmv_pair_estimate` on the scoring
    device, dense and verify alike; the pruned route is the host
    filter-and-verify on either backend."""

    engine = "kmv"

    def __init__(self, sketches: PackedSketches, seed: int,
                 backend: str = "torch", device="cuda"):
        self.sketches = SketchArena.from_pack(sketches)
        self.seed = int(seed)
        self.backend = normalize_backend(backend)
        self.device = resolve_device(device)

    def _sketch_pack(self) -> SketchArena:
        return self.sketches

    def _scoring_pack(self) -> PackedSketches:
        """The columns on the index's device for ``"torch"``, on the CPU
        for ``"numpy"``."""
        dev = self.device if self.backend == "torch" else torch.device("cpu")
        return self.sketches.device_pack(dev)

    def _query_sketch(self, q_ids) -> np.ndarray:
        """The query's own KMV synopsis: its smallest hashes, as many as
        the index's row width, sorted."""
        k = self.sketches.capacity
        return np.sort(hash_u32_np(np.asarray(q_ids), seed=self.seed))[:k]

    def _query_pack(self, queries):
        """(hash rows, sizes): each query's synopsis and its size."""
        return ([self._query_sketch(q) for q in queries],
                np.asarray([len(q) for q in queries], np.int64))

    def _plan_queries(self, queries):
        """((hash rows, sizes), hash rows, empty bit rows, sizes)."""
        qp = self._query_pack(queries)
        hash_rows, sizes = qp
        return qp, hash_rows, [np.zeros(0, np.int64)] * len(queries), sizes

    def _row_scores(self, x, q_hashes, q_len: int, rows=None) -> torch.Tensor:
        """Ĉ = D̂∩ / |Q| (f32) of one query against every record of the
        pack ``x`` or the records ``rows``, on ``x``'s device."""
        qv = np.full(x.capacity, PAD, np.uint32)
        qv[: len(q_hashes)] = q_hashes
        xv, xl = x.values, x.lengths
        if rows is not None:
            idx = torch.from_numpy(np.asarray(rows, np.int64)).to(xv.device)
            xv, xl = xv[idx], xl[idx]
        d_hat, _, _ = kmv_pair_estimate(to_tensor(qv).to(xv.device),
                                        len(q_hashes), xv, xl)
        # A tensor divisor: CUDA divides by a host scalar as a product
        # with its reciprocal, one ulp off the reference's quotient.
        return d_hat / torch.full_like(d_hat, float(max(int(q_len), 1)))

    def _score_matrix(self, queries, *, as_numpy: bool, qp=None):
        hash_rows, sizes = qp if qp is not None else \
            self._query_pack(queries)
        x = self._scoring_pack()
        s = torch.stack([self._row_scores(x, h, n)
                         for h, n in zip(hash_rows, sizes)], dim=-1) \
            if len(hash_rows) else \
            torch.zeros((x.num_records, 0), dtype=torch.float32,
                        device=x.device)
        return s.cpu().numpy() if as_numpy else s

    def _pair_score_fn(self, qp):
        """Scores of a ragged (record, query) list, query by query. On a
        card it has ``prefetch``, as :class:`PairScorer` has: the host
        top-k scores its bound-ordered list in a few growing prefixes."""
        hash_rows, sizes = qp
        x = self._scoring_pack()

        def score(cand_rec, cand_q):
            cand_rec, cand_q = np.asarray(cand_rec), np.asarray(cand_q)
            out = np.zeros(len(cand_rec), np.float32)
            for g in np.unique(cand_q):
                sel = np.nonzero(cand_q == g)[0]
                out[sel] = self._row_scores(x, hash_rows[g], sizes[g],
                                            rows=cand_rec[sel]).cpu().numpy()
            return out

        score.prefetch = x.device.type == "cuda"
        return score

    def save(self, path: str) -> None:
        np.savez_compressed(path, engine="kmv", seed=np.int64(self.seed),
                            backend=_BACKEND_TO_FILE[self.backend],
                            **_arena_to_npz(self.sketches))
