"""``repro_torch.api`` — the GB-KMV engine of ``repro.api`` on PyTorch/CUDA.

    engine = repro_torch.api.get_engine("gbkmv")
    index  = engine.build(records, budget)            # device="cuda"
    hits   = index.batch_query(queries, 0.5)          # one id array per query
    top    = index.topk(q_ids, k=10)                  # (ids, scores)
    index.save(path); repro_torch.api.load_index(path)

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; with no card a default call raises. ``backend="torch"``
scores with the hand kernels on CUDA (their plain versions on CPU
tensors), ``"numpy"`` with the host estimator. ``build_backend="torch"``
runs the fused device build (the B2 kernel), ``"numpy"`` the host build.

``query``/``batch_query``/``topk`` take ``plan`` ∈ {"auto", "dense",
"pruned"} as the reference does: "auto" asks the planner to pick the
cheaper route per batch from the postings' selectivity, the others force
one. Every route returns the same answers.

- The dense route scores every record (kernel B1).
- The pruned route with ``backend="torch"`` is the device pipeline
  (``planner/device.py``): postings probe (kernel B3), block decode and
  K∩ scatter (kernel B4), the closed-form estimator, and packed hit words
  or a top-k, with one staged upload and one fetch per batch.
- The pruned route with ``backend="numpy"`` is the reference's host
  filter-and-verify: candidates from the block postings on the host,
  scored in one call (the host twin of kernel B5).

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

from repro_torch import planner
from repro_torch.core import gbkmv as gbkmv_mod
from repro_torch.core.arena import SketchArena
from repro_torch.core.estimators import containment_matrix, normalize_backend
from repro_torch.core.hashing import to_numpy
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
        if windowed:
            raise _not_ported("windowed=True (the time-windowed index)",
                              "slice 5")
        _validate_postings_arg(postings)
        device = resolve_device(device)
        core = gbkmv_mod.build_gbkmv(
            records, budget=budget, r=r, seed=seed, capacity=capacity,
            tau_mode=tau_mode, build_backend=build_backend, device=device)
        idx = GBKMVApiIndex(core, budget=int(budget), backend=backend,
                            device=device)
        if postings == "eager":
            arena = idx.core.sketches
            if build_backend == "torch":
                # Encoded where the columns live, the tail mirror adopted
                # as it is; the columns are pinned to the host once and
                # stay resident on the device.
                post, dpost = build_postings_device(arena)
                arena.ensure_host()
                arena.install_postings(post)
                arena.adopt_device_postings(dpost)
            else:
                arena.postings()
        return idx

    @classmethod
    def _load(cls, d: dict, device) -> "GBKMVApiIndex":
        core = gbkmv_mod.GBKMVIndex(
            sketches=_arena_from_npz(d), tau=np.uint32(d["tau"]),
            top_elems=np.asarray(d["top_elems"], np.int64),
            seed=int(d["seed"]), buffer_bits=int(d["buffer_bits"]))
        budget = int(d["budget"]) if "budget" in d else -1
        stored = str(d.get("backend", "jnp"))
        return GBKMVApiIndex(core, budget=budget if budget >= 0 else None,
                             backend=_BACKEND_FROM_FILE.get(stored, stored),
                             device=device)


class GBKMVApiIndex:
    """A built GB-KMV index behind the reference's planned query protocol.

    ``query``/``batch_query``/``topk`` take ``plan`` ∈ {"auto", "dense",
    "pruned"}. The postings live on the arena, built on the first planned
    query. The pruned route runs the device pipeline for
    ``backend="torch"`` and the host filter-and-verify for ``"numpy"``.
    """

    engine = "gbkmv"
    last_plan: QueryPlan | None = None     # the latest planned batch's route
    # Per query, on the host pruned route; None on the device route, which
    # makes no candidate sets.
    last_candidate_sizes: list | None = None

    def __init__(self, core: gbkmv_mod.GBKMVIndex, budget: int | None,
                 backend: str = "torch", device="cuda"):
        core.sketches = SketchArena.from_pack(core.sketches)
        self.core = core
        self.budget = budget
        self.backend = normalize_backend(backend)
        self.device = resolve_device(device)

    @property
    def num_records(self) -> int:
        return self.core.num_records

    def _scoring_pack(self) -> PackedSketches:
        """The columns the backend scores: resident on the index's device
        for ``"torch"``, the arena itself for ``"numpy"``."""
        x = self.core.sketches
        return x.device_pack(self.device) if self.backend == "torch" else x

    def _score_matrix(self, queries, *, as_numpy: bool, qp=None):
        """f32[m, Gq] for a query batch: a tensor on the index's device
        for the torch backend (unless ``as_numpy``), numpy otherwise."""
        if qp is None:
            qp = gbkmv_mod.sketch_query_batch(self.core, queries)
        return containment_matrix(qp, self._scoring_pack(),
                                  backend=self.backend, as_numpy=as_numpy)

    # -- planner hooks --------------------------------------------------------

    def _postings(self) -> PostingsIndex:
        return self.core.sketches.postings()

    def _plan_queries(self, queries):
        """(query pack, retained-hash rows, buffer-bit rows, sizes)."""
        qp = gbkmv_mod.sketch_query_batch(self.core, queries)
        return (qp,) + planner.unpack_query_rows(qp)

    def _pair_score_fn(self, qp):
        """The ragged verify scorer over this index and query pack (placed
        once, not per scored chunk)."""
        return PairScorer(self._scoring_pack(), qp, backend=self.backend)

    def _dense_batch_query(self, queries, threshold, qp=None):
        """The comparison runs where the scores are; only the mask is
        fetched."""
        s = self._score_matrix(queries, as_numpy=False, qp=qp)
        return threshold_hits_packed(s, threshold)

    def _dense_topk(self, q_ids, k: int, qp=None):
        s = self._score_matrix([q_ids], as_numpy=True, qp=qp)[:, 0]
        return topk_select(np.arange(len(s), dtype=np.int64), s, k, len(s))

    # -- queries ------------------------------------------------------------

    def scores(self, q_ids) -> np.ndarray:
        """Estimated containment Ĉ(Q→X) for every record (f32[m])."""
        return self._score_matrix([q_ids], as_numpy=True)[:, 0]

    def batch_scores(self, queries) -> np.ndarray:
        """f32[m, Gq] — one index sweep for a whole query batch."""
        return self._score_matrix(queries, as_numpy=True)

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
        s = self.core.sketches
        decision = planner.choose_plan(
            self._postings(), hash_rows, bit_rows, threshold,
            s.num_records, s.capacity, plan=plan)
        self.last_plan = decision
        if decision.path == "dense":
            return self._dense_batch_query(queries, threshold, qp=qp)
        if self.backend == "torch":
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
        s = self.core.sketches
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
        if self.backend == "torch":
            return planner_device.pruned_topk_device(
                s, qp, k, device=self.device)[0]
        return planner.pruned_topk(
            self._postings(), hash_rows[0], bit_rows[0], int(sizes[0]), k,
            self._pair_score_fn(qp), s.num_records)

    def insert(self, new_records, budget: int | None = None):
        raise _not_ported("insert (dynamic maintenance)", "slice 5")

    def save(self, path: str) -> None:
        np.savez_compressed(path, engine="gbkmv", **index_to_arrays(self))

    def nbytes(self) -> int:
        return self.core.nbytes()
