"""``repro_torch.api`` — the GB-KMV engine of ``repro.api`` on PyTorch/CUDA.

    engine = repro_torch.api.get_engine("gbkmv")
    index  = engine.build(records, budget)            # device="cuda"
    hits   = index.batch_query(queries, 0.5)          # one id array per query
    top    = index.topk(q_ids, k=10)                  # (ids, scores)
    index.save(path); repro_torch.api.load_index(path)

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; with no card a default call raises. ``backend="torch"``
scores with the B1 kernel on CUDA (its plain version on CPU), ``"numpy"``
with the host estimator. ``build_backend="torch"`` runs the fused device
build (the B2 kernel), ``"numpy"`` the host build.

This slice serves the dense sweep: ``plan="dense"`` and ``plan="auto"``
both score every record (the reference's planner returns the same answers
on either route). ``plan="pruned"``, ``insert`` and ``windowed=True``
raise ``NotImplementedError`` until their slices of the port land.

Index files use the reference's npz keys, so a file saved by either
package loads in the other. A port file carries no ``post_*`` (postings)
keys, which makes it a valid v1-style reference file; on load the port
ignores ``post_*`` keys.
"""

from __future__ import annotations

import zipfile

import numpy as np

from repro_torch.core import gbkmv as gbkmv_mod
from repro_torch.core.arena import SketchArena
from repro_torch.core.estimators import containment_matrix, normalize_backend
from repro_torch.core.hashing import to_numpy
from repro_torch.core.sketches import PackedSketches
from repro_torch.device import resolve_device
from repro_torch.planner import (QueryPlan, normalize_plan, threshold_hits_packed,
                                 topk_select)

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


def _arena_to_npz(s: PackedSketches) -> dict:
    """The packed columns under the reference's npz keys (u32 columns as
    uint32). No postings keys: postings arrive with slice 3."""
    return {
        "values": to_numpy(s.values),
        "lengths": s.lengths.cpu().numpy(),
        "thresh": to_numpy(s.thresh),
        "buf": to_numpy(s.buf),
        "sizes": s.sizes.cpu().numpy(),
        "arena_version": np.int64(_ARENA_VERSION),
    }


def _arena_from_npz(d: dict) -> SketchArena:
    """An arena (CPU tensors) from the column keys of any reference file
    version; ``post_*`` postings keys are ignored."""
    return SketchArena.from_pack(PackedSketches.from_numpy(
        values=np.asarray(d["values"], np.uint32),
        lengths=d["lengths"], thresh=np.asarray(d["thresh"], np.uint32),
        buf=np.asarray(d["buf"], np.uint32), sizes=d["sizes"]))


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
              windowed=False, device="cuda"):
        """Vectorized construction. ``backend`` picks the scoring
        implementation, ``build_backend`` the construction path;
        ``tau_mode`` ∈ {"exact", "histogram"}."""
        if windowed:
            raise _not_ported("windowed=True (the time-windowed index)",
                              "slice 5")
        device = resolve_device(device)
        core = gbkmv_mod.build_gbkmv(
            records, budget=budget, r=r, seed=seed, capacity=capacity,
            tau_mode=tau_mode, build_backend=build_backend, device=device)
        return GBKMVApiIndex(core, budget=int(budget), backend=backend,
                             device=device)

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
    """A built GB-KMV index behind the reference's query protocol."""

    engine = "gbkmv"
    last_plan: QueryPlan | None = None

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

    def _score_matrix(self, queries, *, as_numpy: bool):
        """f32[m, Gq] for a query batch: a tensor on the index's device
        for the torch backend (unless ``as_numpy``), numpy otherwise."""
        qp = gbkmv_mod.sketch_query_batch(self.core, queries)
        x = self.core.sketches
        if self.backend == "torch":
            x = x.device_pack(self.device)
        return containment_matrix(qp, x, backend=self.backend,
                                  as_numpy=as_numpy)

    def _dense_plan(self, plan: str) -> None:
        if normalize_plan(plan) == "pruned":
            raise _not_ported("plan='pruned' (postings and the planner)",
                              "slices 3-4")
        self.last_plan = QueryPlan("dense", np.nan, np.nan, 0,
                                   "planner not yet ported")

    def scores(self, q_ids) -> np.ndarray:
        """Estimated containment Ĉ(Q→X) for every record (f32[m])."""
        return self._score_matrix([q_ids], as_numpy=True)[:, 0]

    def batch_scores(self, queries) -> np.ndarray:
        """f32[m, Gq] — one index sweep for a whole query batch."""
        return self._score_matrix(queries, as_numpy=True)

    def query(self, q_ids, threshold: float, *, plan: str = "auto"):
        return self.batch_query([q_ids], threshold, plan=plan)[0]

    def batch_query(self, queries, threshold: float, *,
                    plan: str = "auto") -> list[np.ndarray]:
        """Record ids with Ĉ ≥ threshold, one sorted array per query. The
        comparison runs where the scores are; only the mask is fetched."""
        self._dense_plan(plan)
        queries = [np.asarray(q) for q in queries]
        if not queries:
            return []
        s = self._score_matrix(queries, as_numpy=False)
        return threshold_hits_packed(s, threshold)

    def topk(self, q_ids, k: int, *,
             plan: str = "auto") -> tuple[np.ndarray, np.ndarray]:
        """(record ids, scores) of the k highest estimated containments:
        score descending, ties by ascending record id."""
        self._dense_plan(plan)
        s = self.scores(q_ids)
        return topk_select(np.arange(len(s), dtype=np.int64), s, k, len(s))

    def insert(self, new_records, budget: int | None = None):
        raise _not_ported("insert (dynamic maintenance)", "slice 5")

    def save(self, path: str) -> None:
        np.savez_compressed(path, engine="gbkmv", **index_to_arrays(self))

    def nbytes(self) -> int:
        return self.core.nbytes()
