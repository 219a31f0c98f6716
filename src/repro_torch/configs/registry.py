"""Architecture registry: ``--arch <id>`` → config module (port of
``repro.configs.registry``). It holds the archs whose forward the port
has; the reference's other ids raise as unknown ones do."""

from __future__ import annotations

import importlib

ARCH_IDS = ["qwen3-0.6b"]

_MODULES = {"qwen3-0.6b": "qwen3_0_6b"}


def get_module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is unknown or not yet ported; "
                       f"ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
