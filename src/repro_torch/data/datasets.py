"""Named dataset stand-ins for paper Table II (numpy copy of
``repro.data.datasets``).

Each spec carries the dataset's published skew statistics (α1 element
frequency, α2 record size); generation is deterministic from the seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synth import generate_dataset


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    m: int                 # records after scaling
    n_elems: int           # element universe after scaling
    alpha_freq: float      # α1 (Table II)
    alpha_size: float      # α2 (Table II)
    size_min: int
    size_max: int
    seed: int


# Table II, scaled ~100-1000×; (α1, α2) exact.
SPECS: dict[str, DatasetSpec] = {
    "NETFLIX": DatasetSpec("NETFLIX", 4000, 17770, 1.14, 4.95, 10, 1200, 11),
    "DELIC":   DatasetSpec("DELIC",   4000, 45000, 1.14, 3.05, 10, 600, 12),
    "COD":     DatasetSpec("COD",     1000, 120000, 1.09, 1.81, 10, 8000, 13),
    "ENRON":   DatasetSpec("ENRON",   4000, 60000, 1.16, 3.10, 10, 800, 14),
    "REUTERS": DatasetSpec("REUTERS", 4000, 28000, 1.32, 6.61, 10, 500, 15),
    "WEBSPAM": DatasetSpec("WEBSPAM", 1500, 80000, 1.33, 9.34, 100, 6000, 16),
    "WDC":     DatasetSpec("WDC",     8000, 100000, 1.08, 2.40, 10, 300, 17),
}


def load(name: str, scale: float = 1.0) -> list[np.ndarray]:
    spec = SPECS[name]
    m = max(int(spec.m * scale), 50)
    n = max(int(spec.n_elems * scale), 500)
    return generate_dataset(
        m=m, n_elems=n, alpha_freq=spec.alpha_freq, alpha_size=spec.alpha_size,
        size_min=spec.size_min, size_max=min(spec.size_max, max(n // 4, 20)),
        seed=spec.seed,
    )
